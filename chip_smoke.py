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
   the MEI and the panorama camera, and through a 2-view rig (the scene
   of ``tests/test_multiview.py``: unaligned ATE under 0.05, the rig's
   view 0 at identity);
6. drives seven main paths, each a seeded synthetic 720p stream through
   ``DefaultAnnotationPipeline`` on ``cuda`` (random DroidNet weights from a
   seed), with the kernels' launch counts set to 0 just before and read
   just after: the default (volume, bf16, speculative keyframe ordering),
   ``slam.corr_mode: alt``, ``slam.corr_dtype: int8``, the default again,
   the reference ordering (``keyframe_spec_depth: 1``, ``proximity_spec:
   false``), and twice an MEI camera with the stream's own intrinsics
   (``init.intrinsics: gt``), masks with an invalid band and the constant
   keyframe depth prior; prints frames, keyframes, removals (late ones
   too), waits on deferred reads, wall seconds, fps, peak memory (overall
   and per stage), stage host seconds and launches of each.  A spy copies
   to host memory the coords of the first frontend call (at the largest
   edge count) and of the first backend call that reach each kernel;
7. drives two rig main paths the same way: a seeded synthetic pair of
   720p streams (view 1 seen through the rig's offset) as a
   ``MultiviewVideoList`` through the pipeline, volume (K1) and
   ``corr_mode: alt`` (K2), each frame edge expanded into one edge per
   view; prints time steps and view-frames per second besides;
8. UniDepth-L (ViT-L/14, the 512-wide decoder; seeded random weights):
   holds the net on the card to the CPU in IEEE f32 at 224×280, the bf16
   SLAM prior to the f32 one at 532×952 (a 720p frame), times the forward
   at 532×952 in bf16 and f32 against the operations it counts; then
   drives the volume main path twice with ``slam.keyframe_depth:
   unidepth-l`` and checks every keyframe's disparity prior;
9. the post-SLAM depth stage: holds VDA-S, VDA-L (one 32-frame window)
   and PriorDA's conditioned fine DAv2-B on the card to the CPU in IEEE
   f32 at a small input and VDA's bf16 autocast to its f32 at 518×924,
   and times them against their FLOP bounds; drives the 720p video twice
   with full.yaml's depth settings (``slam.keyframe_depth: unidepth-l``,
   ``post.depth_align_model: adaptive_unidepth-l_svda``), records the
   branch the map's coverage chose, the depth stages and the KNN's card
   time per frame, and checks every frame's depth; then runs the
   processor alone on that run's SLAM output with the threshold set so
   that the other branch (metric or PriorDA) runs;
10. TrackAnything (seeded random weights, IEEE f32): holds
   GroundingDINO (Swin-T, BERT-base; its encoder and query selection, then
   its decoder from the card's selection) on the 736×1344 canvas of a 720p
   frame with full.yaml's caption, SAM ViT-B (the 1024² encoder, both
   decoder passes on 32 fixed boxes, the composite) and DeAOT R50-L (the
   reference step on a fixed three-object map, the propagation step, at
   592×1040) on the card to the CPU, counts the discrete results that flip
   (rank swaps of the selection, boxes over the threshold, mask pixels,
   instance and slot maps) and times each net against its f32 FLOP bound;
   then drives the 720p video twice with ``init.instance:
   track_anything`` and full.yaml's ten phrases, the card's nets in the
   model cache, and records boxes kept per detection, instances per frame,
   DeAOT's slots and the stage's host seconds and peaks;
   Metric3D v2 (seeded random weights, IEEE f32): holds Metric3D-small
   and -large on the card to the CPU at the canonical 616×1064 (depth,
   normals, confidence) and times both against their f32 FLOP bounds;
   drives the 720p video twice with ``slam.keyframe_depth:
   metric3d-large`` (the prior's calls, its stage's host seconds and peak,
   every prior finite and positive, their bits), then the depth stage's
   processor on its metric branch (``adaptive_metric3d-large_svda``) on
   that run's SLAM output; drives it twice with ``slam.sparse_tracks``
   (``ShiftTracker``: a keypoint grid moved by the stream's known shift)
   and ``slam.visualize`` (the BA's track rows, the snapshot read back),
   and once with ``slam.infill_dense_disp`` in ``corr_mode: alt`` (one
   finite disparity map per frame);
   holds the two volume runs, the two MEI runs, the two UniDepth runs, the
   two depth runs, the two TrackAnything runs, the two Metric3D runs and
   the two sparse-tracks runs to each other: equal keyframes, removals and
   K1 launches, bit-equal trajectories and intrinsics (and depths,
   instance maps, keyframe priors, track rows);
11. GeoCalib: fits the LM on the card to exact up and latitude fields at
   320×544 (pinhole over three frames, simple_mei with k1) and holds it to
   ground truth; holds ``GeoCalibNet`` (seeded weights) on the card to
   the same module on the CPU and times its forward; drives the main path
   with ``init.intrinsics: geocalib`` (volume), its threshold calibrated
   on the GeoCalib-stamped stream, and checks that every frame carries
   the GeoCalib result; prints the stage's host seconds and peak;
12. times K1 (volume runs) and K2 (alt runs) on the coords captured in the
   single-view and the rig runs, with seeded features of the same shapes,
   warm and with a cold L2 cache, and holds both against their plain
   versions on a 720p rig edge set with cross-view edges (the main path
   proposes none), in volume/bf16, volume/int8 and alt;
13. prints the ``kernels`` JSON line (K1's launches on the GeoCalib, the
    UniDepth, the depth, the TrackAnything, the Metric3D, the
    sparse-tracks and the infill paths too, K2's on the infill path) and,
    last, the ``ok`` JSON line.

Kernel times come from CUDA events: the mean of back-to-back launches
(warm L2) as ``ms``, and the median of launches each preceded by a 128 MB
write (cold L2, as the main path calls them) as ``cold_ms``;
``bound_share`` is ``bound_ms / ms``.

It exits non-zero without a result when no CUDA card is present, and in a
directory that does not hold the ``vipe_tpu_torch`` package.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import hashlib
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
RIG_VIEWS = 2
RIG_SHIFT_PX = 48  # view 1's crop of the canvas sits this far right of view 0's
RIG_XI = [0.12, 0.0, 0.0, 0.0, 0.1, 0.0]  # view 1: 0.12 m right, yawed 0.1 rad
# GeoCalib's inference size for a 720p frame: short side 320, width cropped
# to a multiple of 32
GEOCALIB_H, GEOCALIB_W = 320, 544
GEOCALIB_NET_TOL = 1e-4  # card against CPU, both IEEE f32 (no TF32)
# UniDepth-L: the net's input for a 720p frame under its pixel bounds
# (200k-500k: no padding, ×0.7366 to 532×952), and a small input for the
# card-against-CPU check
UNIDEPTH_H, UNIDEPTH_W = 532, 952
UNIDEPTH_SMALL_H, UNIDEPTH_SMALL_W = 224, 280
UNIDEPTH_NET_RTOL = 1e-3  # card against CPU, both IEEE f32, relative to the largest value
# the bf16 SLAM prior against the f32 one on the card, relative to the
# largest prior: bf16 activations through 24 blocks and the decoder
UNIDEPTH_BF16_RTOL = 5e-2


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


def rig_oracle_phase():
    """The 2-view rig scene of ``tests/test_multiview.py`` on the card (48×64,
    10 frames, view 1 0.12 m right and yawed 0.1 rad, per-view intrinsics,
    GT-flow oracle through the rig chain): the rig base's unaligned ATE must
    stay under that test's 0.05 and the rig's view 0 at identity to 1e-6."""
    import torch

    from vipe_tpu_torch.ops import cameras as cam
    from vipe_tpu_torch.ops import geom, lie
    from vipe_tpu_torch.slam import system as slam_system
    from vipe_tpu_torch.streams.base import (FrameAttribute, MultiviewVideoList, VideoFrame,
                                             VideoStream)

    H, W, T, V, depth = 48, 64, 10, RIG_VIEWS, 2.0
    ht, wd = H // 8, W // 8
    rng = np.random.default_rng(11)
    c2w = [lie.se3_identity()]
    for _ in range(1, T):
        xi = torch.tensor([0.06, 0.004 * rng.normal(), 0.003 * rng.normal(),
                           0.002 * rng.normal(), 0.003 * rng.normal(), 0.002 * rng.normal()],
                          dtype=torch.float32)
        c2w.append(lie.se3_mul(c2w[-1], lie.se3_exp(xi)))
    gt_c2w = torch.stack(c2w)
    rig = torch.stack([lie.se3_identity(), lie.se3_exp(torch.tensor(RIG_XI))])
    u, v = geom.pixel_grid(ht, wd)
    base = (1.0 / depth) * (1.0 + 0.1 * torch.sin(u / 2.0) * torch.cos(v / 1.5))
    disps = torch.stack([base * (1.0 + 0.02 * (k % 3)) for k in range(T * V)])
    intr = torch.tensor([[W * 1.2, W * 1.2, W / 2.0, H / 2.0],
                         [W * 1.15, W * 1.15, W / 2.0, H / 2.0]])

    class View(VideoStream):
        def __init__(self, view):
            self.view = view
            self.imgs = [rng.random((H, W, 3)).astype(np.float32) for _ in range(T)]

        def __len__(self):
            return T

        def frame_size(self):
            return (H, W)

        def attributes(self):
            return {FrameAttribute.RGB, FrameAttribute.INTRINSICS, FrameAttribute.METRIC_DEPTH}

        def __iter__(self):
            for k in range(T):
                d = disps[k * V + self.view].numpy()
                yield VideoFrame(raw_frame_idx=k, rgb=self.imgs[k],
                                 metric_depth=np.kron(1.0 / d, np.ones((8, 8), np.float32)),
                                 intrinsics=intr[self.view].numpy().copy())

    dev = torch.device("cuda")
    P, R, D = lie.se3_inv(gt_c2w).to(dev), rig.to(dev), disps.to(dev)
    I_grid = (intr / 8.0).to(dev)
    live = {}

    class SpyBuffer(slam_system.GraphBuffer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            live["buf"] = self

    def oracle(net, inp, corr, motn, ii, jj, num_frames):
        buf = live["buf"]
        coords1 = motn[..., :2] + geom.coords_grid(ht, wd, dev)
        di, dj = ii.cpu().numpy(), jj.cpu().numpy()
        fi = torch.as_tensor(buf.tstamp[di // V], device=dev)
        fj = torch.as_tensor(buf.tstamp[dj // V], device=dev)
        qi = torch.as_tensor(di % V, device=dev)
        qj = torch.as_tensor(dj % V, device=dev)
        gt, valid = geom.reproject_mv(P, R, D, I_grid, cam.CameraType.PINHOLE,
                                      fi, qi, fi * V + qi, fj, qj)
        weight = valid[..., None].float().expand_as(gt).contiguous()
        return net, gt - coords1, weight, torch.full((num_frames, ht, wd), 0.01, device=dev)

    oracle.host_only = True  # reads host state: the sequential frontend

    def zeros(images):
        return torch.zeros((images.shape[0], ht, wd, 128), dtype=torch.bfloat16, device=dev)

    orig = slam_system.GraphBuffer
    slam_system.GraphBuffer = SpyBuffer
    try:
        out = slam_system.SLAMSystem(
            config=dict(resize_area=H * W, filter_thresh=-1.0, keyframe_thresh=0.0,
                        warmup=4, buffer=64, infill_chunk_size=6, backend_iters=8),
            device=dev, update_fn=oracle, encode_features=zeros,
            encode_context=lambda im: (zeros(im), zeros(im)),
        ).run(MultiviewVideoList("rig_oracle", [View(0), View(1)], rig.numpy()))
    finally:
        slam_system.GraphBuffer = orig
    traj = out.trajectory
    ate = float(np.sqrt(((traj[:, :3] - gt_c2w[:, :3].numpy()) ** 2).sum(-1).mean()))
    rig0_err = float(np.abs(out.rig[0] - np.array([0, 0, 0, 0, 0, 0, 1.0])).max())
    if not (traj.shape == (T, 7) and np.isfinite(traj).all() and ate < 0.05):
        raise AssertionError(f"rig oracle SLAM on the card: unaligned ATE {ate} (limit 0.05)")
    if not rig0_err <= 1e-6 or out.intrinsics.shape != (V, 4):
        raise AssertionError(f"rig oracle SLAM: rig view 0 off identity by {rig0_err}, "
                             f"intrinsics {out.intrinsics.shape}")
    return {"camera": "pinhole rig", "views": V, "frames": T,
            "keyframes": len(out.keyframes), "unaligned_ate": ate, "limit": 0.05,
            "rig_view0_max_err": rig0_err}


# ------------------------------------------------------------------ main path


def synth_stream(n_frames: int, h: int = MAIN_H, w: int = MAIN_W, seed: int = 0,
                 intrinsics=None, mask_rows: int = 0, x_offset: int = 0, pad: int = 0):
    """A textured canvas translated frame by frame (real flow, no parallax),
    made from ``seed``.  With ``intrinsics`` every frame carries them; with
    ``mask_rows`` every frame's validity mask marks that many bottom rows
    invalid (a band, like a car's hood).  ``pad`` widens the canvas and
    ``x_offset`` moves the crop right: two streams of one seed and pad are
    two views of one canvas."""
    from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream

    rng = np.random.default_rng(seed)
    base = rng.random((h + 64, w + 64 + pad, 3)).astype(np.float32)
    mask = None
    if mask_rows:
        mask = np.ones((h, w), bool)
        mask[h - mask_rows:] = False

    class Synth(VideoStream):
        _name = f"synth{seed}" + (f"_x{x_offset}" if x_offset else "")

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
                ox, oy = (k * 5) % 64 + x_offset, (k * 3) % 64
                yield VideoFrame(
                    raw_frame_idx=k, rgb=base[oy: oy + h, ox: ox + w], mask=mask,
                    intrinsics=None if intrinsics is None else np.array(intrinsics, np.float32))

    return Synth()


def rig_streams(n_frames: int, seed: int = 0):
    """A rig of two views of one seeded canvas, view 1's crop
    ``RIG_SHIFT_PX`` to the right of view 0's, with the rig poses."""
    import torch

    from vipe_tpu_torch.ops import lie

    views = [synth_stream(n_frames, seed=seed, pad=RIG_SHIFT_PX, x_offset=x)
             for x in (0, RIG_SHIFT_PX)]
    rig = torch.stack([lie.se3_identity(), lie.se3_exp(torch.tensor(RIG_XI))]).numpy()
    return views, rig


def calibrate_filter_thresh(streams, n_keyframes: int) -> float:
    """With random DroidNet weights the motion-filter scores have no fixed
    scale.  Score every frame against every earlier frame as reference, then
    pick the threshold whose filter pass (the first and the last frame are
    always keyframes) gives the keyframe count nearest ``n_keyframes``.
    ``streams``: one stream, or a rig's list of views (scored together)."""
    import torch

    from vipe_tpu_torch.models.droidnet import build_droidnet
    from vipe_tpu_torch.slam.motion_filter import MotionFilter
    from vipe_tpu_torch.slam.system import StandardResizeStreamProcessor, droidnet_fns
    from vipe_tpu_torch.streams.base import ProcessedVideoStream

    model = build_droidnet("cuda")
    ef, ec, uf = droidnet_fns(model)
    mf = MotionFilter(ef, ec, uf, thresh=1e9)
    streams = streams if isinstance(streams, list) else [streams]
    frames = zip(*(ProcessedVideoStream(s, [StandardResizeStreamProcessor()]) for s in streams))

    def upload(views):
        rgb = np.stack([(np.clip(f.rgb, 0, 1) * 255).astype(np.uint8) for f in views])
        return torch.from_numpy(rgb[0] if len(views) == 1 else rgb).cuda()

    with torch.no_grad():
        toks = [mf.submit(upload(views)) for views in frames]
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


def mainpath_coords_phase(kernels, key: str = "mainpath_coords"):
    """Times K1 and K2 on the coords the main path gave them, with seeded
    features of the same shapes: a kernel's time depends on the coords, not
    on the values.  ``kernels`` maps "K1"/"K2" to (record, what
    ``coords_spy`` captured in the run that launches it); adds ``key`` to
    each record."""
    import torch

    from vipe_tpu_torch.ops import corr as corr_ops
    from vipe_tpu_torch.ops import corr_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    for kernel, (rec, captured) in kernels.items():
        rec[key] = {}
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
            rec[key][role] = {
                "E": E, "grid": [ht, wd], "calls": cap["calls"], "edges_seen": sorted(cap["edges"]),
                "max_abs_err": err, "tol": 1e-4,
                "ms": ms, "cold_ms": _cuda_ms_cold(run, 20),
                "bound_ms": bound_s * 1e3, "bound_share": bound_s * 1e3 / ms,
                "bound_bytes": moved,
            }
            del ops, f1, f2, coords
            torch.cuda.empty_cache()


def cross_view_phase():
    """K1 and K2 against their plain versions on a rig edge set with
    cross-view edges (frame edges ``i → i``, which target the other view),
    at the 720p SLAM grid: the correlation state and the coords that a
    2-view ``FactorGraph`` builds for its expanded edges, in volume/bf16,
    volume/int8 and alt.  The main path proposes no cross-view edge, so
    this is where they meet the kernels."""
    import torch

    from vipe_tpu_torch.ops import corr_kernels as ck
    from vipe_tpu_torch.ops import lie
    from vipe_tpu_torch.slam.buffer import GraphBuffer
    from vipe_tpu_torch.slam.factor_graph import FactorGraph

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    n, V, H, W = 6, RIG_VIEWS, 328, 584  # 720p → 328×584 SLAM frames → 41×73 grid
    rig = torch.stack([lie.se3_identity(), lie.se3_exp(torch.tensor(RIG_XI))])
    buf = GraphBuffer(H, W, buffer_size=8, device=dev, n_views=V, rig=rig.numpy())
    xi = torch.zeros((n, 6), device=dev)
    xi[:, 0] = 0.05 * torch.arange(n, device=dev)
    buf.poses[:n] = lie.se3_exp(xi)
    buf.disps[: n * V] = 0.5 + 0.1 * torch.rand((n * V, buf.ht, buf.wd), generator=g, device=dev)
    buf.intrinsics = torch.tensor([[500.0, 500.0, W / 2, H / 2], [520.0, 520.0, W / 2, H / 2]],
                                  device=dev)
    buf.fmaps[: n * V] = torch.randn((n * V, buf.ht, buf.wd, 128), generator=g,
                                     device=dev).to(torch.bfloat16)
    buf.n_frames = n
    out = {}
    for mode, dtype in (("volume", "bf16"), ("volume", "int8"), ("alt", "bf16")):
        graph = FactorGraph(buf, None, max_factors=48, incremental=True, corr_mode=mode,
                            corr_dtype=dtype)
        graph.add_neighborhood_factors(0, n, r=2)
        graph.add_factors(np.arange(n), np.arange(n))
        coords, _ = buf.reproject_exp(graph.exp)
        coords = coords.contiguous()
        if mode == "alt":
            p = graph.corr_pyr
            err = float((ck.corr_fused(p[0], p[1:], coords)
                         - ck.corr_fused_plain(p[0], p[1:], coords)).abs().max())
        else:
            err = float((ck.corr_lookup(graph.corr_pyr, coords, scales=graph.corr_scale)
                         - ck.corr_lookup_plain(graph.corr_pyr, coords, scales=graph.corr_scale)
                         ).abs().max())
        cross = int((graph.exp[:, 0] == graph.exp[:, 3]).sum())
        if not err <= 1e-4 or cross != n * V:
            raise AssertionError(f"{mode}/{dtype} on rig edges with {cross} cross-view rows: "
                                 f"max abs err {err} > 1e-4")
        out[f"{mode}_{dtype}"] = {"E": int(coords.shape[0]), "cross_view_rows": cross,
                                  "max_abs_err": err, "tol": 1e-4}
        del graph, coords
    del buf
    torch.cuda.empty_cache()
    return out


def main_path_phase(label, slam_cfg, n_frames, thresh, required, stream_kw=None,
                    init=None, rig=False, post=None, keep=None):
    """One run of the main path with ``slam_cfg`` over ``n_frames`` of the
    seeded stream (``stream_kw``: its intrinsics and mask band), or with
    ``rig`` of the seeded rig's views; ``post``: the pipeline's post
    section (the depth stage).  ``required`` names the launch counts that
    must be > 0.  ``keep``: a dict that gets the pipeline's output."""
    import gc

    import torch

    from vipe_tpu_torch.ops import cameras as cam
    from vipe_tpu_torch.ops import corr_kernels as ck
    from vipe_tpu_torch.pipeline.default import DefaultAnnotationPipeline
    from vipe_tpu_torch.streams.base import MultiviewVideoList
    from vipe_tpu_torch.utils import profiling

    if rig:
        views, rig_poses = rig_streams(n_frames)
        stream = MultiviewVideoList("synth_rig", views, rig_poses)
    else:
        stream = synth_stream(n_frames, **(stream_kw or {}))
    n_views = len(stream) if rig else 1
    pipe = DefaultAnnotationPipeline(
        init=init or {"intrinsics": "fov", "fov_deg": 60.0},
        slam={"optimize_intrinsics": True, "filter_thresh": thresh, **slam_cfg},
        post=post or {}, output={"path": None}, device="cuda", return_payload=True,
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
    if keep is not None:
        keep["output"] = out
    traj = np.asarray(out.trajectory)
    if traj.shape != (n_frames, 7) or not np.isfinite(traj).all():
        raise AssertionError(f"{label} main path: trajectory {traj.shape} not finite / wrong shape")
    if not np.isfinite(out.intrinsics).all() or out.intrinsics.shape != (n_intr,):
        raise AssertionError(f"{label} main path: intrinsics {out.intrinsics}")
    views_out = out.payload.get("view_outputs", [out])
    if rig:
        if slam_out.intrinsics.shape != (n_views, n_intr) or len(views_out) != n_views:
            raise AssertionError(f"{label} main path: rig intrinsics {slam_out.intrinsics.shape}"
                                 f", {len(views_out)} views")
        if not np.isfinite(slam_out.rig).all():
            raise AssertionError(f"{label} main path: rig {slam_out.rig}")
    for view_out in views_out:
        traj = np.asarray(view_out.trajectory)
        quat_norm = np.linalg.norm(traj[:, 3:], axis=-1)
        if not np.isfinite(traj).all() or not np.allclose(quat_norm, 1.0, atol=1e-3):
            raise AssertionError(f"{label} main path: poses not finite or rotations not unit "
                                 "quaternions")
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"{label} main path did not launch {name}")
    return {
        "label": label, "slam": slam_cfg,
        "frames": n_frames, "views": n_views, "resolution": [MAIN_H, MAIN_W],
        "keyframes": int(len(slam_out.keyframes)), "filter_thresh": thresh,
        "wall_s": wall, "fps": n_frames / wall, "view_frames_per_s": n_frames * n_views / wall,
        "peak_mem_gib": peak / 2 ** 30, "resident_before_gib": resident / 2 ** 30,
        "stage_peak_mem_gib": peaks,
        "launches": launches,
        "stages_host_s": stages,
        "intrinsics": np.asarray(slam_out.intrinsics).tolist(),
        # bits of the results, to hold two runs of one path to each other
        "intrinsics_hex": [float(v).hex() for v in np.asarray(out.intrinsics).ravel()],
        "trajectory_sha1": hashlib.sha1(np.ascontiguousarray(out.trajectory).tobytes()).hexdigest(),
        **({"rig": np.asarray(slam_out.rig).tolist()} if rig else {}),
        "ba_residual": float(out.ba_residual),
        # frontend: keyframes removed, removed late, waits on deferred reads
        **slam_out.frontend_stats,
    }, captured


# ------------------------------------------------------------------ GeoCalib


def geocalib_lm_phase():
    """The LM fit on the card, from exact up and latitude fields that the
    port's ``fields`` make at 320×544 (focal 400 px): pinhole, three frames
    sharing the focal (frame 0 at roll 0.1, pitch -0.15), and simple_mei
    with k1 0.35 from one frame.  The focal must come back within 2 % (5 %
    for simple_mei), roll and pitch within 0.01 (0.02), k1 within 0.05, as
    ``tests/test_geocalib.py`` asks of the JAX package."""
    import torch

    from vipe_tpu_torch.priors.geocalib import calibrate_from_fields, latitude_field, up_field

    dev = torch.device("cuda")
    h, w, focal = GEOCALIB_H, GEOCALIB_W, 400.0
    out = {}
    for model, rolls, pitches, k1, f_tol, rp_tol in (
            ("pinhole", [0.1, -0.05, 0.2], [-0.15, 0.1, 0.0], None, 0.02, 0.01),
            ("simple_mei", [0.1], [-0.15], 0.35, 0.05, 0.02)):
        roll, pitch = torch.tensor(rolls, device=dev), torch.tensor(pitches, device=dev)
        f_t = torch.tensor(focal, device=dev)
        up = up_field(h, w, f_t, roll, pitch, k1=k1, model=model)
        lat = latitude_field(h, w, f_t, roll, pitch, k1=k1, model=model)
        times = []
        for _ in range(2):  # first call, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = calibrate_from_fields(up, lat, model=model)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        errs = {"focal_rel": abs(float(res.focal) - focal) / focal,
                "roll": float((res.roll.cpu() - torch.tensor(rolls)).abs().max()),
                "pitch": float((res.pitch.cpu() - torch.tensor(pitches)).abs().max()),
                "k1": abs(float(res.k1) - k1) if k1 is not None else 0.0}
        if not (errs["focal_rel"] < f_tol and errs["roll"] < rp_tol and errs["pitch"] < rp_tol
                and errs["k1"] < 0.05):
            raise AssertionError(f"GeoCalib LM on the card ({model}) missed ground truth: {errs}")
        out[model] = {"frames": len(rolls), "size": [h, w], "n_iters": res.n_iters,
                      "focal": float(res.focal), "k1": float(res.k1), "errors": errs,
                      "first_ms": times[0], "ms": times[1]}
    return out


def geocalib_net_phase():
    """``GeoCalibNet`` (seeded random weights and NMF bases) on one seeded
    320×544 image, on the card against the same module on the CPU, both in
    IEEE f32, within ``GEOCALIB_NET_TOL``; the card's forward timed by CUDA
    events."""
    import torch

    from vipe_tpu_torch.priors.geocalib.network import GeoCalibNet, init_geocalib_, nmf_bases
    from vipe_tpu_torch.utils.device import true_f32

    net = init_geocalib_(GeoCalibNet(), seed=0).eval().requires_grad_(False)
    bases = nmf_bases(torch.Generator().manual_seed(0))
    x = torch.rand((1, 3, GEOCALIB_H, GEOCALIB_W), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), true_f32():
        ref = net(x, bases)
        net = net.to("cuda")
        xg, bg = x.cuda(), bases.cuda()
        got = net(xg, bg)
        errs = {k: float((got[k].cpu() - ref[k]).abs().max()) for k in ref}
        ms = _cuda_ms(lambda: net(xg, bg), 10)
    if not max(errs.values()) <= GEOCALIB_NET_TOL:
        raise AssertionError(f"GeoCalibNet on the card against the CPU: {errs} "
                             f"(limit {GEOCALIB_NET_TOL})")
    del net, xg, bg, got
    torch.cuda.empty_cache()
    return {"size": [GEOCALIB_H, GEOCALIB_W], "precision": "f32 convolutions and matmuls, TF32 off",
            "max_abs_err": errs, "tol": GEOCALIB_NET_TOL, "forward_ms": ms}


@contextlib.contextmanager
def geocalib_spy():
    """While active, records each ``GeoCalibIntrinsicsProcessor``'s result
    and the intrinsics it stamps on each frame; yields the dict."""
    from vipe_tpu_torch.pipeline.processors import GeoCalibIntrinsicsProcessor as Proc

    orig_calibrate, orig_call = Proc.calibrate, Proc.__call__
    seen = {"results": [], "stamped": []}

    def calibrate(self, frames):
        orig_calibrate(self, frames)
        seen["results"].append(np.array(self._intr))

    def call(self, frame_idx, frame):
        frame = orig_call(self, frame_idx, frame)
        seen["stamped"].append(np.array(frame.intrinsics))
        return frame

    Proc.calibrate, Proc.__call__ = calibrate, call
    try:
        yield seen
    finally:
        Proc.calibrate, Proc.__call__ = orig_calibrate, orig_call


def geocalib_main_path_phase():
    """``init.intrinsics: geocalib`` (pinhole, volume) on the seeded 32-frame
    720p stream, the motion-filter threshold calibrated on the
    GeoCalib-stamped stream; the stamped intrinsics must be the GeoCalib
    result on every frame."""
    from vipe_tpu_torch.pipeline.processors import GeoCalibIntrinsicsProcessor
    from vipe_tpu_torch.streams.base import ProcessedVideoStream

    raw = synth_stream(MAIN_FRAMES)
    stamped = ProcessedVideoStream(raw, [GeoCalibIntrinsicsProcessor(sample_stream=raw,
                                                                     device="cuda")])
    thresh = calibrate_filter_thresh(stamped, MAIN_KEYFRAMES)
    with geocalib_spy() as seen:
        rec, captured = main_path_phase("geocalib", {}, MAIN_FRAMES, thresh, ["corr_lookup"],
                                        init={"intrinsics": "geocalib"})
    if len(seen["results"]) != 1 or len(seen["stamped"]) != MAIN_FRAMES or not all(
            np.array_equal(i, seen["results"][0]) for i in seen["stamped"]):
        raise AssertionError(f"geocalib main path: {len(seen['results'])} calibrations, "
                             f"{len(seen['stamped'])} stamped frames, not all equal to the result")
    rec["geocalib"] = {"intrinsics": seen["results"][0].tolist(),
                       "host_s": rec["stages_host_s"]["geocalib"]["s"],
                       "peak_mem_gib": rec["stage_peak_mem_gib"]["geocalib"]}
    return rec, captured


# ------------------------------------------------------------------ UniDepth


def _rel_err(ref, got) -> float:
    ref, got = ref.double().cpu(), got.double().cpu()
    return float((ref - got).abs().max() / ref.abs().max())


def unidepth_net_phase():
    """UniDepth-L at its published width (ViT-L/14 and the 512-wide
    decoder), seeded random weights: the card against the CPU in IEEE f32 at
    224×280 (given rays and the predicted camera); the SLAM prior in bf16
    against the same path in f32 on the card at 532×952 (a seeded 720p
    uint8 frame, focal 900 px); forward times at 532×952 in bf16 and f32
    by CUDA events, warm, with the operations counted by
    ``torch.utils.flop_counter`` and the bound at the card's peak for the
    type."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from vipe_tpu_torch.priors.depth.factory import make_depth_model
    from vipe_tpu_torch.priors.depth.unidepth import UniDepthModel, pinhole_rays
    from vipe_tpu_torch.utils.device import true_f32

    out = {"variant": "vitl", "precision_check": "f32 convolutions and matmuls, TF32 off"}
    cpu = UniDepthModel("l", device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 3, UNIDEPTH_SMALL_H, UNIDEPTH_SMALL_W), generator=g)
    intr = torch.tensor([[300.0, 300.0, UNIDEPTH_SMALL_W / 2 + 3.3, UNIDEPTH_SMALL_H / 2 - 2.1]])
    rays = pinhole_rays(intr, (UNIDEPTH_SMALL_H, UNIDEPTH_SMALL_W))
    errs = {}
    with torch.no_grad(), true_f32():
        refs = {cam: cpu.net(x, r) for cam, r in (("given_rays", rays), ("predicted", None))}
        net = cpu.net.to("cuda")
        for cam, r in (("given_rays", rays), ("predicted", None)):
            got = net(x.cuda(), None if r is None else r.cuda())
            errs[cam] = {k: _rel_err(refs[cam][k], got[k])
                         for k in ("depth", "confidence", "intrinsics")}
    del cpu, net, refs, got
    worst = max(v for e in errs.values() for v in e.values())
    if not worst <= UNIDEPTH_NET_RTOL:
        raise AssertionError(f"UniDepthNet on the card against the CPU: {errs} "
                             f"(limit {UNIDEPTH_NET_RTOL})")
    out["card_vs_cpu"] = {"size": [UNIDEPTH_SMALL_H, UNIDEPTH_SMALL_W], "rel_err": errs,
                          "tol": UNIDEPTH_NET_RTOL}

    # a model of its own for the f32 checks: the factory's, which the main
    # paths below reuse, then holds only its bf16 weights on the card
    model = UniDepthModel("l", device="cuda")
    img = torch.randint(0, 256, (MAIN_H, MAIN_W, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(2)).cuda()
    row = torch.tensor([900.0, 900.0, MAIN_W / 2, MAIN_H / 2], device="cuda")
    sens16 = model.estimate_sens_device(img, row)
    sens32 = model.estimate_sens_device(img, row, dtype=torch.float32)
    err = _rel_err(sens32, sens16)
    if not (bool(torch.isfinite(sens16).all()) and bool((sens16 > 0).all())
            and err <= UNIDEPTH_BF16_RTOL):
        raise AssertionError(f"UniDepth bf16 prior against f32 on the card: {err} "
                             f"(limit {UNIDEPTH_BF16_RTOL}), finite and positive?")
    out["bf16_vs_f32_prior"] = {"frame": [MAIN_H, MAIN_W], "grid": list(sens16.shape),
                                "rel_err": err, "tol": UNIDEPTH_BF16_RTOL}

    xs = torch.randn((1, 3, UNIDEPTH_H, UNIDEPTH_W), generator=g).cuda()
    big_rays = pinhole_rays(torch.tensor([[663.0, 663.0, UNIDEPTH_W / 2, UNIDEPTH_H / 2]]),
                            (UNIDEPTH_H, UNIDEPTH_W)).cuda()
    timing = {}
    with torch.no_grad():
        for name, net, dtype, peak in (("bf16", model.net_bf16, torch.bfloat16,
                                        BF16_TENSOR_FLOPS_PER_S),
                                       ("f32", model.net, torch.float32, F32_FLOPS_PER_S)):
            xin, rin = xs.to(dtype), big_rays.to(dtype)
            with true_f32():
                with FlopCounterMode(display=False) as fc:
                    net(xin, rin)
                flops = fc.get_total_flops()
                torch.cuda.reset_peak_memory_stats()
                ms = _cuda_ms(lambda: net(xin, rin), 5)
            timing[name] = {"ms": ms, "flops": flops, "bound_ms": flops / peak * 1e3,
                            "bound_by": "operations", "tflops_per_s": flops / ms / 1e9,
                            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    out["forward"] = {"size": [UNIDEPTH_H, UNIDEPTH_W], **timing,
                      "params": sum(p.numel() for p in model.net.parameters())}
    del model, xs, img
    torch.cuda.empty_cache()
    make_depth_model("unidepth-l", device="cuda").net_bf16  # built before the timed runs
    return out


@contextlib.contextmanager
def unidepth_spy():
    """While active, counts the calls of the UniDepth prior and keeps the
    SLAM buffers it fills; yields the dict."""
    from vipe_tpu_torch.priors.depth.unidepth import UniDepthModel
    from vipe_tpu_torch.slam.buffer import GraphBuffer

    orig_sens, orig_update = UniDepthModel.estimate_sens_device, GraphBuffer.update_disps_sens
    seen = {"calls": 0, "buffers": []}

    def sens(self, *args, **kwargs):
        seen["calls"] += 1
        return orig_sens(self, *args, **kwargs)

    def update(self, depth_model, frame_idx=None):
        if not any(b is self for b in seen["buffers"]):
            seen["buffers"].append(self)
        return orig_update(self, depth_model, frame_idx)

    UniDepthModel.estimate_sens_device, GraphBuffer.update_disps_sens = sens, update
    try:
        yield seen
    finally:
        UniDepthModel.estimate_sens_device, GraphBuffer.update_disps_sens = orig_sens, orig_update


def unidepth_main_path_phase(label, thresh):
    """``slam.keyframe_depth: unidepth-l`` (volume) on the seeded 32-frame
    720p stream: the prior runs on every keyframe, and again on every
    keyframe when the backend changes the focal.  Every keyframe's
    disparity prior must be finite and positive."""
    import torch

    with unidepth_spy() as seen:
        rec, captured = main_path_phase(label, {"keyframe_depth": "unidepth-l"}, MAIN_FRAMES,
                                        thresh, ["corr_lookup"])
    if len(seen["buffers"]) != 1:
        raise AssertionError(f"{label}: the prior filled {len(seen['buffers'])} buffers")
    buf = seen["buffers"][0]
    sens = buf.disps_sens[:buf.n_frames]
    if buf.n_frames != rec["keyframes"] or not (bool(torch.isfinite(sens).all())
                                                and bool((sens > 0).all())):
        raise AssertionError(f"{label}: keyframe disparity priors not finite and positive "
                             f"({buf.n_frames} slots, {rec['keyframes']} keyframes)")
    stage = rec["stages_host_s"]["keyframe_depth"]
    rec["keyframe_depth"] = {"prior_calls": seen["calls"], "stage_calls": stage["n"],
                             "host_s": stage["s"],
                             "peak_mem_gib": rec["stage_peak_mem_gib"]["keyframe_depth"],
                             "prior_min": float(sens.min()), "prior_max": float(sens.max())}
    del buf, sens, seen
    return rec, captured


# ------------------------------------------------------- post-SLAM depth

DEPTH_ALIGN = "adaptive_unidepth-l_svda"  # configs/pipeline/full.yaml's post stage
# VDA's and PriorDA's input for a 720p frame: short side 518, sides multiples of 14
VDA_H, VDA_W = 518, 924
DEPTH_SMALL = (70, 98)  # the card-against-CPU check's input
DEPTH_NET_RTOL = 1e-3  # card against CPU, both IEEE f32, relative to the largest value
DEPTH_BF16_RTOL = 5e-2  # bf16 against f32 on the card, relative to the largest value
PRIORDA_CHECK_FRAMES = 2  # frames of the first PriorDA chunk held card against CPU
COND_MAX = 1e3  # a pixel's 2×2 solve is held strictly below this condition number
PRIORDA_STUB_RTOL = 1e-4  # the stub coarse net's completion, card against CPU


@contextlib.contextmanager
def depth_spy():
    """While active, records each ``AdaptiveDepthProcessor``'s branch and
    coverage score, times every PriorDA KNN on the card (CUDA events
    around the call) with its query and prompt-point counts, and keeps the
    model, frames and prompts of the first ``PRIORDA_CHECK_FRAMES`` frames
    that PriorDA completes."""
    import torch

    from vipe_tpu_torch.pipeline import processors
    from vipe_tpu_torch.priors.depth import priorda

    orig_decide, orig_knn = processors.AdaptiveDepthProcessor._decide, priorda.knn
    orig_complete = priorda.PriorDAModel.complete_batch
    seen = {"decisions": [], "knn": []}

    def complete_batch(self, rgbs, prompt_depths):
        if "priorda_chunk" not in seen:
            n = PRIORDA_CHECK_FRAMES
            seen["priorda_chunk"] = (self, [np.array(r, np.float32) for r in rgbs[:n]],
                                     [np.array(p, np.float32) for p in prompt_depths[:n]])
        return orig_complete(self, rgbs, prompt_depths)

    def decide(self, frame):
        use_metric = orig_decide(self, frame)
        seen["decisions"].append({"coverage": self.coverage,
                                  "branch": "metric" if use_metric else "priorda"})
        return use_metric

    def knn(query, points, k=1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_knn(query, points, k)
        end.record()
        end.synchronize()
        seen["knn"].append({"queries": int(query.shape[0]), "prompt_points": int(points.shape[0]),
                            "ms": start.elapsed_time(end)})
        return out

    processors.AdaptiveDepthProcessor._decide, priorda.knn = decide, knn
    priorda.PriorDAModel.complete_batch = complete_batch
    try:
        yield seen
    finally:
        processors.AdaptiveDepthProcessor._decide, priorda.knn = orig_decide, orig_knn
        priorda.PriorDAModel.complete_batch = orig_complete


def _depths_record(depths, n_frames, label):
    """Checks one depth per frame, finite and positive, f32 at the frame
    size; returns their range and the sha1 of their bits."""
    if len(depths) != n_frames:
        raise AssertionError(f"{label}: {len(depths)} depths for {n_frames} frames")
    for k, d in enumerate(depths):
        d = np.asarray(d)
        if d.shape != (MAIN_H, MAIN_W) or d.dtype != np.float32 or not (
                np.isfinite(d).all() and (d > 0).all()):
            raise AssertionError(f"{label}: frame {k}'s depth {d.shape} {d.dtype} is not finite "
                                 "and positive at the frame size")
    sha = hashlib.sha1()
    for d in depths:
        sha.update(np.ascontiguousarray(d).tobytes())
    return {"min": float(min(np.min(d) for d in depths)),
            "max": float(max(np.max(d) for d in depths)), "sha1": sha.hexdigest()}


def _knn_record(knn_calls, n_frames):
    if not knn_calls:
        return None
    ms = [c["ms"] for c in knn_calls]
    pts = [c["prompt_points"] for c in knn_calls]
    return {"frames": len(knn_calls), "of_frames": n_frames, "queries": knn_calls[0]["queries"],
            "prompt_points_min": min(pts), "prompt_points_max": max(pts),
            "ms_per_frame_mean": float(np.mean(ms)), "ms_per_frame_max": max(ms)}


DEPTH_STAGES = ("vda", "post_metric_depth", "priorda")


def depth_main_path_phase(label, thresh, keep):
    """configs/pipeline/full.yaml's depth settings on the seeded 32-frame
    720p stream: ``slam.keyframe_depth: unidepth-l`` and
    ``post.depth_align_model: adaptive_unidepth-l_svda`` (volume, FOV
    intrinsics, no instances).  Every frame's depth must be finite and
    positive; records the branch the coverage chose, the score, the depth
    stages' host seconds and peaks, and the KNN's card time when PriorDA
    ran.  ``keep`` gets the output and the depths."""
    with depth_spy() as seen:
        rec, captured = main_path_phase(label, {"keyframe_depth": "unidepth-l"}, MAIN_FRAMES,
                                        thresh, ["corr_lookup"],
                                        post={"depth_align_model": DEPTH_ALIGN}, keep=keep)
    if len(seen["decisions"]) != 1:
        raise AssertionError(f"{label}: {len(seen['decisions'])} depth decisions")
    keep["depths"] = list(keep["output"].depths)
    keep["priorda_chunk"] = seen.get("priorda_chunk")
    stages, peaks = rec["stages_host_s"], rec["stage_peak_mem_gib"]
    rec["depth_align"] = {
        "model": DEPTH_ALIGN, **seen["decisions"][0],
        "stages_host_s": {k: stages[k] for k in DEPTH_STAGES if k in stages},
        "stage_peak_mem_gib": {k: peaks[k] for k in DEPTH_STAGES if k in peaks},
        "knn": _knn_record(seen["knn"], MAIN_FRAMES),
        "depth": _depths_record(keep["depths"], MAIN_FRAMES, label)}
    return rec, captured


def depth_other_branch_phase(main_rec, keep):
    """``AdaptiveDepthProcessor`` called directly on the depth main path's
    SLAM output and the seeded stream's frames (the SLAM intrinsics on
    each), with the coverage threshold set so that the branch the main
    path did not take runs: the metric branch (UniDepth-L, bf16, chunks of
    8) or PriorDA (DAv2-B coarse at 518×924 in f32, the KNN over the
    projected map; coarse only without fine weights).  Records host
    seconds and peaks per stage and the KNN's card time per frame."""
    import gc

    import torch

    from vipe_tpu_torch.pipeline.processors import AdaptiveDepthProcessor
    from vipe_tpu_torch.utils import profiling

    slam_out = keep["output"].payload["slam_output"]
    taken = main_rec["depth_align"]["branch"]
    thresh = 0.0 if taken == "metric" else 2.0  # a coverage below it takes the metric branch
    frames = []
    for f in synth_stream(MAIN_FRAMES):
        f.intrinsics = np.asarray(slam_out.intrinsics, np.float32)
        frames.append(f)
    gc.collect()
    torch.cuda.empty_cache()
    profiling.snapshot(reset=True)
    torch.cuda.reset_peak_memory_stats()
    with stage_peaks() as (peaks, top), depth_spy() as seen:
        proc = AdaptiveDepthProcessor(DEPTH_ALIGN, slam_output=slam_out, coverage_thresh=thresh,
                                      device="cuda")
        t0 = time.perf_counter()
        depths = [f.metric_depth for f in proc.update_iterator(iter(frames))]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    branch = "metric" if proc.use_metric else "priorda"
    if branch == taken:
        raise AssertionError(f"the forced run took the {branch} branch again "
                             f"(coverage {proc.coverage}, threshold {thresh})")
    if branch == "priorda" and not seen["knn"]:
        raise AssertionError("the PriorDA branch ran no KNN: the projected map is empty")
    keep["priorda_chunk"] = keep["priorda_chunk"] or seen.get("priorda_chunk")
    return {"branch": branch, "coverage": proc.coverage, "coverage_thresh": thresh,
            "frames": MAIN_FRAMES, "resolution": [MAIN_H, MAIN_W], "wall_s": wall,
            "fps": MAIN_FRAMES / wall,
            "peak_mem_gib": max(top[0], torch.cuda.max_memory_allocated()) / 2 ** 30,
            "stage_peak_mem_gib": peaks, "stages_host_s": profiling.snapshot(reset=True),
            "knn": _knn_record(seen["knn"], MAIN_FRAMES),
            "depth": _depths_record(depths, MAIN_FRAMES, f"forced {branch}")}


def _knn_reference(queries, points, k):
    """Exact k nearest neighbours on the host, independent of
    ``ops/knn.py``: a k-d tree's k + 16 nearest (scipy), their squared
    distances in f64 (exact on integer pixels), ordered by (distance,
    index); a query whose last candidate ties its k-th neighbour (a tie
    the tree may have cut) is searched by brute force.  Returns (squared
    distances (Q, k) f64, indices (Q, k) int64)."""
    from scipy.spatial import cKDTree

    queries, points = np.asarray(queries, np.float64), np.asarray(points, np.float64)
    m = min(k + 16, len(points))
    _, cand = cKDTree(points).query(queries, m, workers=-1)
    cand = np.asarray(cand, np.int64).reshape(len(queries), m)
    d2 = ((queries[:, None, :] - points[cand]) ** 2).sum(-1)
    order = np.lexsort((cand, d2), axis=-1)
    d2, cand = np.take_along_axis(d2, order, 1), np.take_along_axis(cand, order, 1)
    idx = np.arange(len(points))
    for q in np.nonzero((m < len(points)) & (d2[:, -1] == d2[:, k - 1]))[0]:
        d2q = ((queries[q] - points) ** 2).sum(-1)
        order = np.lexsort((idx, d2q))[:k]
        d2[q, :k], cand[q, :k] = d2q[order], order
    return d2[:, :k], cand[:, :k]


def _conditioning(pred, vy, vx, d2, idx):
    """Per pixel, the condition number of the KNN completion's weighted
    2×2 system (f64), as ``tests/test_torch_depth_align.py`` computes it."""
    K = idx.shape[1]
    pr = np.asarray(pred, np.float64)[vy, vx][idx] + 1e-5 * np.arange(1, K + 1)
    w = 1.0 / np.sqrt(np.maximum(d2, 1e-8))
    w /= w.sum(1, keepdims=True)
    a01 = (w * pr).sum(1)
    A = np.stack([np.stack([(w * pr * pr).sum(1), a01], -1), np.stack([a01, w.sum(1)], -1)], -2)
    return np.linalg.cond(A).reshape(pred.shape)


def priorda_card_vs_cpu_phase(chunk):
    """PriorDA's completion on the card against the CPU, on the first
    ``PRIORDA_CHECK_FRAMES`` frames that the depth main path's PriorDA
    completed, with their prompts projected from its SLAM map: every
    pixel of the 720p frame queried against the prompt's pixels.

    * The KNN on the card against ``_knn_reference``: indices and squared
      distances equal.
    * ``complete_batch`` on the card against the same model on the CPU,
      whose KNN is that reference.  With the seeded DAv2-B on the main
      path's prompts: the globally fitted disparity within
      ``DEPTH_NET_RTOL``, and the depth within ``DEPTH_NET_RTOL`` of the
      largest on the pixels off the prompt whose 2×2 system has a
      condition number below ``COND_MAX`` (the seeded net's nearly flat
      disparity leaves few of them).  With the stub coarse net of
      ``tests/test_torch_depth_align.py`` (1 + 0.2·the channel mean of the
      normalised image) on prompts at the same pixels whose depths its
      disparity explains (an affine map of it, 2 % noise, as the test
      makes them): within ``PRIORDA_STUB_RTOL`` on those pixels, which
      must be a tenth or more of each frame's pixels off the prompt.
      Prompt pixels equal and every depth finite in both; the share of
      well-conditioned pixels and the worst pixel beyond ``COND_MAX`` are
      reported."""
    import copy

    import torch

    from vipe_tpu_torch.ops.resize import resize_align_corners
    from vipe_tpu_torch.priors.depth import priorda
    from vipe_tpu_torch.priors.depth.dav2 import preprocess

    model, rgbs, prompts = chunk
    h, w = rgbs[0].shape[:2]
    qy, qx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    queries = np.stack([qx.ravel(), qy.ravel()], -1)
    t0 = time.perf_counter()
    refs = []
    for p in prompts:
        vy, vx = np.nonzero(p > 0)
        refs.append((vy, vx, *_knn_reference(queries, np.stack([vx, vy], -1), model.K)))
    out = {"frames": len(prompts), "queries": int(len(queries)),
           "prompt_points": [int(len(r[0])) for r in refs],
           "knn_reference_s": time.perf_counter() - t0}

    orig_knn, orig_kss = priorda.knn, priorda.knn_scale_shift_completion

    def run(m, prompt_depths):
        seen = {"knn": [], "pred": []}

        def knn(query, points, k=1):
            if query.is_cuda:
                d2, idx = orig_knn(query, points, k)
                seen["knn"].append((d2.cpu().numpy(), idx.cpu().numpy()))
                return d2, idx
            vy, vx, d2, idx = refs[len(seen["knn"])]
            if not np.array_equal(points.numpy(), np.stack([vx, vy], -1)):
                raise AssertionError("the CPU run's prompt points are not the reference's")
            seen["knn"].append((d2, idx))
            return torch.from_numpy(d2.astype(np.float32)), torch.from_numpy(idx)

        def kss(pred, sparse, mask, K=5):
            seen["pred"].append(pred.cpu().numpy())
            return orig_kss(pred, sparse, mask, K)

        priorda.knn, priorda.knn_scale_shift_completion = knn, kss
        try:
            depths = m.complete_batch(rgbs, prompt_depths)
        finally:
            priorda.knn, priorda.knn_scale_shift_completion = orig_knn, orig_kss
        return [np.asarray(d) for d in depths], seen

    cpu = copy.copy(model)
    cpu.device = torch.device("cpu")
    cpu.net = copy.deepcopy(model.net).cpu()
    if model.fine_net is not None:
        cpu.fine_net = copy.deepcopy(model.fine_net).cpu()
    card_stub, cpu_stub = copy.copy(model), copy.copy(cpu)
    card_stub.net = cpu_stub.net = lambda x: 1.0 + 0.2 * torch.mean(x, 1)
    disp = resize_align_corners(cpu_stub.net(preprocess(np.stack(rgbs), model.input_size, "cpu"))
                                [:, None], (h, w))[:, 0].numpy()
    rng = np.random.default_rng(0)
    stub_prompts = [np.where(p > 0, (1.0 / (0.8 * d + 0.1)) * (1 + 0.02 * rng.standard_normal(
        d.shape)), 0.0).astype(np.float32) for p, d in zip(prompts, disp)]
    for name, card_m, cpu_m, prompt_depths, tol in (
            ("seeded_dav2_vitb", model, cpu, prompts, DEPTH_NET_RTOL),
            ("stub_net", card_stub, cpu_stub, stub_prompts, PRIORDA_STUB_RTOL)):
        t0 = time.perf_counter()
        got, card_seen = run(card_m, prompt_depths)
        ref, cpu_seen = run(cpu_m, prompt_depths)
        rec = {"tol": tol, "cond_max": COND_MAX, "seconds": time.perf_counter() - t0,
               "frames": []}
        for k, ((d2, idx), (_, _, rd2, ridx)) in enumerate(zip(card_seen["knn"], refs)):
            if not (np.array_equal(idx, ridx) and np.array_equal(d2.astype(np.float64), rd2)):
                bad = np.nonzero((idx != ridx).any(1) | (d2 != rd2).any(1))[0]
                raise AssertionError(f"frame {k}: the card's KNN differs from the exact "
                                     f"reference at {len(bad)} queries, first {bad[:5]}")
        for k, ((vy, vx, rd2, ridx), g, r) in enumerate(zip(refs, got, ref)):
            mask = prompt_depths[k] > 0
            if not (np.isfinite(g).all() and np.isfinite(r).all()):
                raise AssertionError(f"PriorDA {name}, frame {k}: a depth is not finite")
            if not np.array_equal(g[mask], r[mask]):
                raise AssertionError(f"PriorDA {name}, frame {k}: the prompt pixels differ")
            # the pixels off the prompt, split by their solve's conditioning
            cond = _conditioning(cpu_seen["pred"][k], vy, vx, rd2, ridx)[~mask]
            good = cond < COND_MAX
            err = (np.abs(g.astype(np.float64) - r) / np.abs(r).max())[~mask]
            fr = {"well_conditioned_share": float(good.mean()),
                  "max_rel_err_well_conditioned": float(err[good].max()) if good.any() else None,
                  "max_rel_err_other": float(err[~good].max()) if (~good).any() else None,
                  "fitted_disp_rel_err": _rel_err(torch.from_numpy(cpu_seen["pred"][k]),
                                                  torch.from_numpy(card_seen["pred"][k]))}
            if fr["fitted_disp_rel_err"] > DEPTH_NET_RTOL:
                raise AssertionError(f"PriorDA {name}, frame {k}: the card's fitted disparity "
                                     f"is {fr['fitted_disp_rel_err']} off the CPU's")
            if name == "stub_net" and good.mean() < 0.1:
                raise AssertionError(f"PriorDA {name}, frame {k}: only {good.mean():.3f} of the "
                                     "pixels off the prompt well conditioned")
            if good.any() and err[good].max() > tol:
                raise AssertionError(f"PriorDA {name}, frame {k}: {err[good].max()} on the well-"
                                     f"conditioned pixels (limit {tol})")
            rec["frames"].append(fr)
        out[name] = rec
    out["knn_equal"] = True
    return out


def _net_timing(forward, peak_flops):
    """One ``forward()``'s operations (``torch.utils.flop_counter``), its
    warm time by CUDA events, the bound at ``peak_flops`` and the peak
    memory."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        forward()
    flops = fc.get_total_flops()
    torch.cuda.reset_peak_memory_stats()
    ms = _cuda_ms(forward, 3)
    return {"ms": ms, "flops": flops, "bound_ms": flops / peak_flops * 1e3,
            "bound_by": "operations", "bound_share": flops / peak_flops * 1e3 / ms,
            "tflops_per_s": flops / ms / 1e9,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def depth_nets_phase():
    """The depth stage's nets at their published widths, seeded random
    weights: VDA-S and VDA-L (ViT-S/L, features 64/256, four temporal
    modules) and PriorDA's conditioned fine DAv2-B (``cond_dim`` 3).  Each
    on the card against the same module on the CPU in IEEE f32 at a small
    input (32 frames at 70×98 for VDA, 2 frames for DAv2); VDA's bf16
    against its f32 on the card on one 32-frame window at 518×924; times
    by CUDA events against the operations ``torch.utils.flop_counter``
    counts: VDA per window in bf16 autocast (989 TFLOP/s), DAv2-B on a
    chunk of 8 frames in f32 (67 TFLOP/s)."""
    import torch

    from vipe_tpu_torch.priors.depth.dav2 import build_dav2_net
    from vipe_tpu_torch.priors.depth.videodepthanything import build_vda_net, precision
    from vipe_tpu_torch.utils.device import true_f32

    g = torch.Generator().manual_seed(5)
    out = {"precision_check": "f32 convolutions and matmuls, TF32 off"}
    small = torch.randn((32, 3) + DEPTH_SMALL, generator=g)
    clip = torch.randint(0, 256, (32, 3, VDA_H, VDA_W), dtype=torch.uint8, generator=g).cuda()
    for variant in ("vits", "vitl"):
        net = build_vda_net(variant, None, 0, "cpu")
        with torch.no_grad(), true_f32():
            ref = net(small)
            net = net.cuda()
            err = _rel_err(ref, net(small.cuda()))
            f32 = net(clip)
        with torch.no_grad(), precision(torch.device("cuda"), torch.bfloat16):
            err16 = _rel_err(f32, net(clip))
            timing = _net_timing(lambda: net(clip), BF16_TENSOR_FLOPS_PER_S)
        if not (err <= DEPTH_NET_RTOL and err16 <= DEPTH_BF16_RTOL):
            raise AssertionError(f"VDA {variant}: card against CPU {err} (limit {DEPTH_NET_RTOL}), "
                                 f"bf16 against f32 {err16} (limit {DEPTH_BF16_RTOL})")
        out[f"vda_{variant}"] = {
            "card_vs_cpu": {"size": [32, *DEPTH_SMALL], "rel_err": err, "tol": DEPTH_NET_RTOL},
            "bf16_vs_f32": {"size": [32, VDA_H, VDA_W], "rel_err": err16, "tol": DEPTH_BF16_RTOL},
            "window_bf16": {"frames": 32, "size": [VDA_H, VDA_W], **timing},
            "params": sum(p.numel() for p in net.parameters())}
        del net, f32, ref
        torch.cuda.empty_cache()

    net = build_dav2_net("vitb", None, 0, "cpu", cond_dim=3)
    x = torch.randn((2, 3) + DEPTH_SMALL, generator=g)
    cond = torch.randn((2, 3) + DEPTH_SMALL, generator=g)
    big = [torch.randn((8, 3, VDA_H, VDA_W), generator=g).cuda() for _ in range(2)]
    with torch.no_grad(), true_f32():
        ref = net(x, cond)
        net = net.cuda()
        err = _rel_err(ref, net(x.cuda(), cond.cuda()))
        timing = _net_timing(lambda: net(*big), F32_FLOPS_PER_S)
    if not err <= DEPTH_NET_RTOL:
        raise AssertionError(f"PriorDA fine DAv2-B on the card against the CPU: {err} "
                             f"(limit {DEPTH_NET_RTOL})")
    out["priorda_fine_dav2_vitb"] = {
        "card_vs_cpu": {"size": [2, *DEPTH_SMALL], "rel_err": err, "tol": DEPTH_NET_RTOL},
        "chunk_f32": {"frames": 8, "size": [VDA_H, VDA_W], **timing},
        "params": sum(p.numel() for p in net.parameters())}
    del net, big, clip
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- TrackAnything

# configs/pipeline/full.yaml's phrases
TA_PHRASES = ["person", "animal", "vehicle", "ball", "balloon", "gun", "pet", "car", "bus", "sky"]
TA_NET_RTOL = 1e-3  # card against CPU, both IEEE f32, relative to the largest value
SAM_BOXES = 32  # one decoder batch (SamPredictor.SEG_CHUNK)
SAM_MIN_AREA = 200  # SegTracker's


def _ta_frames(n: int = 2):
    """Two seeded 720p uint8 frames of the main path's canvas (5, 3) px
    apart, with two flat blocks of colour."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (MAIN_H + 64, MAIN_W + 64, 3), dtype=np.uint8)
    base[100:400, 200:600] = (200, 40, 40)
    base[350:700, 700:1000] = (30, 60, 220)
    return [base[3 * k: 3 * k + MAIN_H, 5 * k: 5 * k + MAIN_W].copy() for k in range(n)]


def _ta_boxes():
    """``SAM_BOXES`` seeded boxes over a 720p frame, 40-640 px a side."""
    rng = np.random.default_rng(8)
    x0 = rng.uniform(0, MAIN_W - 40, SAM_BOXES)
    y0 = rng.uniform(0, MAIN_H - 40, SAM_BOXES)
    bw, bh = rng.uniform(40, 640, SAM_BOXES), rng.uniform(40, 400, SAM_BOXES)
    return np.stack([x0, y0, np.minimum(x0 + bw, MAIN_W), np.minimum(y0 + bh, MAIN_H)],
                    -1).astype(np.float32)


def _ta_instance():
    """A fixed 720p instance map: three objects (ids 4, 9, 12)."""
    inst = np.zeros((MAIN_H, MAIN_W), np.int32)
    inst[100:400, 200:600] = 4
    inst[350:700, 700:1000] = 9
    inst[50:200, 900:1250] = 12
    return inst


def _flips(ref, got) -> dict:
    ref, got = np.asarray(ref), np.asarray(got)
    return {"differ": int((ref != got).sum()), "of": int(ref.size)}


def track_anything_nets_phase():
    """TrackAnything's nets at their published widths, seeded random weights
    (each built alike on the CPU and on the card), in IEEE f32: GroundingDINO
    (Swin-T, BERT-base) on the 736×1344 canvas of a 720p frame with
    full.yaml's caption (the encoder and query selection on each device,
    the decoder on each from the card's selection); SAM ViT-B's encoder on the 1024² canvas and its
    decoder (both passes, the resize to the frame) on ``SAM_BOXES`` fixed
    boxes; DeAOT R50-L's reference step (a fixed three-object map) and
    propagation step at 592×1040.  Each held on the card to its CPU run
    within ``TA_NET_RTOL``; the discrete results on the same inputs (boxes
    over the 0.35 threshold, SAM's masks and composite, DeAOT's map)
    compared and their flips counted; each timed warm by CUDA events
    against its f32 FLOP bound.  Returns the record and the card's three
    nets."""
    import torch

    from vipe_tpu_torch.priors.track_anything.deaot import DeAOTTracker
    from vipe_tpu_torch.priors.track_anything.gdino import GroundingDINODetector
    from vipe_tpu_torch.priors.track_anything.sam import SamPredictor
    from vipe_tpu_torch.utils.device import true_f32

    frames = _ta_frames()
    out = {"precision_check": "f32 convolutions and matmuls, TF32 off", "tol": TA_NET_RTOL}
    nets = {}

    # GroundingDINO: the encoder and its query selection on each device,
    # then the decoder on each device from the card's selection (near-equal
    # scores swap ranks between any two runs that round differently, and a
    # swap hands two queries each other's learned embeddings)
    outs = {}
    for dev in ("cpu", "cuda"):
        det = GroundingDINODetector(device=dev)
        ids, *text = det.text_inputs(TA_PHRASES)
        args = [det.preprocess(frames[0])] + [torch.as_tensor(a, device=dev) for a in text]
        with torch.no_grad(), true_f32():
            enc = det.net.encode(*args)
        outs[dev] = det, args, enc, det.net.select(enc["scores"])
    sel = outs["cuda"][3]
    dec = {}
    for dev, (det, args, enc, _) in outs.items():
        with torch.no_grad(), true_f32():
            logits, boxes = det.net.decode(enc, sel.to(dev), args[-1])
        dec[dev] = logits[..., :len(ids)].cpu(), boxes.cpu()
    det, args = outs["cuda"][:2]
    with torch.no_grad(), true_f32():
        timing = _net_timing(lambda: det.net(*args), F32_FLOPS_PER_S)
    kept = {dev: (torch.sigmoid(o[0][0]).amax(-1) > det.box_threshold).numpy()
            for dev, o in dec.items()}
    enc_c, enc_g = outs["cpu"][2], outs["cuda"][2]
    sel_c = outs["cpu"][3].cpu()
    out["gdino"] = {
        "canvas": list(args[0].shape[-2:]), "text_tokens": len(ids), "queries": int(sel.shape[1]),
        "params": sum(p.numel() for p in det.net.parameters()),
        "memory_rel_err": _rel_err(enc_c["memory"], enc_g["memory"]),
        "text_rel_err": _rel_err(enc_c["text"], enc_g["text"]),
        "scores_rel_err": _rel_err(enc_c["scores"], enc_g["scores"]),
        "selection_rank_flips": {"differ": int((sel_c != sel.cpu()).sum()),
                                 "of": int(sel.numel()),
                                 "tokens_not_shared": len(set(sel_c[0].tolist())
                                                          ^ set(sel.cpu()[0].tolist()))},
        "logits_rel_err": _rel_err(dec["cpu"][0], dec["cuda"][0]),
        "boxes_rel_err": _rel_err(dec["cpu"][1], dec["cuda"][1]),
        "over_threshold": int(kept["cuda"].sum()), "threshold_flips": _flips(kept["cpu"],
                                                                             kept["cuda"]),
        "forward_f32": timing}
    ta = {"gdino": det}
    del outs, dec, args, enc_c, enc_g
    torch.cuda.empty_cache()

    # SAM ViT-B
    boxes = _ta_boxes()
    res = {}
    for dev in ("cpu", "cuda"):
        sam = SamPredictor("vit_b", device=dev)
        sam.set_image(frames[0])
        logits = sam.mask_logits(sam.canvas_boxes(boxes))
        res[dev] = (sam, sam._image_embed.cpu(), logits.cpu(),
                    sam.segment_composite(boxes, SAM_MIN_AREA, 1))
    sam = res["cuda"][0]
    canvas = sam.canvas(frames[0])
    pts = sam.canvas_boxes(boxes)
    with torch.no_grad(), true_f32():
        enc = _net_timing(lambda: sam.net.image_encoder(canvas), F32_FLOPS_PER_S)
    dec = _net_timing(lambda: sam.mask_logits(pts), F32_FLOPS_PER_S)
    (_, emb_c, lg_c, (inst_c, ids_c)), (_, emb_g, lg_g, (inst_g, ids_g)) = res["cpu"], \
        res["cuda"]
    out["sam_vit_b"] = {
        "canvas": [sam.img_size, sam.img_size], "boxes": SAM_BOXES,
        "params": sum(p.numel() for p in sam.net.parameters()),
        "embedding_rel_err": _rel_err(emb_c, emb_g), "mask_logits_rel_err": _rel_err(lg_c, lg_g),
        "mask_flips": _flips(lg_c > 0, lg_g > 0),
        "ids_kept": int((ids_g > 0).sum()), "ids_equal": bool(np.array_equal(ids_c, ids_g)),
        "instance_flips": _flips(inst_c, inst_g),
        "encoder_f32": enc, "decoder_two_passes_f32": dec}
    ta["sam"] = sam
    del res, canvas
    torch.cuda.empty_cache()

    # DeAOT R50-L
    res = {}
    for dev in ("cpu", "cuda"):
        tr = DeAOTTracker(device=dev)
        img = tr.preprocess(frames[0])
        mems, _ = tr.reference_memories(img, tr.slots(_ta_instance(), img.shape[-2:]))
        tr.add_reference(frames[0], _ta_instance())
        logits = tr.propagate_logits(tr.preprocess(frames[1]))[0]
        res[dev] = (tr, [m.cpu() for layer in mems for m in layer], logits.cpu(),
                    tr.propagate(frames[1]))
    tr = res["cuda"][0]
    img0, img1 = tr.preprocess(frames[0]), tr.preprocess(frames[1])
    slots = tr.slots(_ta_instance(), img0.shape[-2:])
    ref_t = _net_timing(lambda: tr.reference_memories(img0, slots), F32_FLOPS_PER_S)
    prop_t = _net_timing(lambda: tr.propagate_logits(img1), F32_FLOPS_PER_S)
    out["deaot_r50_l"] = {
        "grid": list(img0.shape[-2:]), "params": sum(p.numel() for p in tr.net.parameters()),
        "memory_rel_err": max(_rel_err(a, b) for a, b in zip(res["cpu"][1], res["cuda"][1])),
        "logits_rel_err": _rel_err(res["cpu"][2], res["cuda"][2]),
        "map_flips": _flips(res["cpu"][3], res["cuda"][3]),
        "reference_step_f32": ref_t, "propagation_step_f32": prop_t}
    tr.restart()
    ta["deaot"] = tr
    del res
    torch.cuda.empty_cache()

    errs = {k: v for net in ("gdino", "sam_vit_b", "deaot_r50_l")
            for k, v in ((f"{net}.{n}", out[net][n]) for n in out[net] if n.endswith("rel_err"))}
    if not max(errs.values()) <= TA_NET_RTOL:
        raise AssertionError(f"TrackAnything nets on the card against the CPU: {errs} "
                             f"(limit {TA_NET_RTOL})")
    return out, ta


@contextlib.contextmanager
def track_anything_spy():
    """While active, records each detection's kept boxes and instances,
    each tracked frame's instances and DeAOT's slots in use, and the share
    of each frame's pixels its mask leaves SLAM; yields the dict."""
    from vipe_tpu_torch.pipeline.processors import TrackAnythingProcessor
    from vipe_tpu_torch.priors.track_anything import SegTracker, TrackAnythingPipeline
    from vipe_tpu_torch.priors.track_anything.gdino import GroundingDINODetector

    orig = (GroundingDINODetector.run_grounding, SegTracker.detect_and_seg,
            TrackAnythingPipeline.track, TrackAnythingProcessor.__call__)
    seen = {"detections": [], "frames": [], "valid_share": []}

    def ground(self, *args, **kwargs):
        out = orig[0](self, *args, **kwargs)
        seen["detections"].append({"boxes_kept": len(out[0])})
        return out

    def detect(self, rgb, phrases):
        instance, id2phrase = orig[1](self, rgb, phrases)
        seen["detections"][-1]["instances"] = len(id2phrase)
        return instance, id2phrase

    def track(self, frame_idx, rgb):
        instance, present = orig[2](self, frame_idx, rgb)
        seen["frames"].append({"instances": len(present),
                               "slots": len(self.tracker.slot_to_id)})
        return instance, present

    def process(self, frame_idx, frame):
        frame = orig[3](self, frame_idx, frame)
        seen["valid_share"].append(float(frame.mask.mean()))
        return frame

    GroundingDINODetector.run_grounding, SegTracker.detect_and_seg, \
        TrackAnythingPipeline.track, TrackAnythingProcessor.__call__ = ground, detect, track, \
        process
    try:
        yield seen
    finally:
        GroundingDINODetector.run_grounding, SegTracker.detect_and_seg, \
            TrackAnythingPipeline.track, TrackAnythingProcessor.__call__ = orig


TA_STAGES = ("track_anything", "ta_detect", "ta_propagate", "ta_host_mask")


def track_anything_main_path_phase(label, thresh):
    """``init.instance: track_anything`` with full.yaml's phrases on the
    seeded 32-frame 720p stream (volume, FOV intrinsics; detections at
    frames 0 and 20, DeAOT between them), the engine from the model cache.
    Every frame gets an instance map of the frame's size; some detection
    must keep an instance.  Records the stages' host seconds and peaks,
    boxes kept per detection, instances per frame, DeAOT's slots and the
    maps' sha1."""
    init = {"intrinsics": "fov", "fov_deg": 60.0, "instance": "track_anything",
            "phrases": TA_PHRASES}
    keep = {}
    with track_anything_spy() as seen:
        rec, captured = main_path_phase(label, {}, MAIN_FRAMES, thresh, ["corr_lookup"],
                                        init=init, keep=keep)
    masks = np.stack(list(keep["output"].instance_masks))
    if masks.shape != (MAIN_FRAMES, MAIN_H, MAIN_W) or len(seen["frames"]) != MAIN_FRAMES:
        raise AssertionError(f"{label}: instance maps {masks.shape}, {len(seen['frames'])} "
                             "tracked frames")
    if not any(d["instances"] for d in seen["detections"]):
        raise AssertionError(f"{label}: no detection kept an instance {seen['detections']}")
    stages, peaks = rec["stages_host_s"], rec["stage_peak_mem_gib"]
    rec["track_anything"] = {
        "phrases": TA_PHRASES, "detections": seen["detections"],
        "instances_per_frame": [f["instances"] for f in seen["frames"]],
        "deaot_slots_per_frame": [f["slots"] for f in seen["frames"]],
        "frames_with_instances": int((masks.reshape(MAIN_FRAMES, -1) > 0).any(1).sum()),
        "slam_valid_share_per_frame": [round(v, 4) for v in seen["valid_share"]],
        "phrases_of_ids": dict(collections.Counter(keep["output"].mask_phrases.values())),
        "stages_host_s": {k: stages[k] for k in TA_STAGES if k in stages},
        "stage_peak_mem_gib": {k: peaks[k] for k in TA_STAGES if k in peaks},
        "instance_sha1": hashlib.sha1(np.ascontiguousarray(masks.astype(np.int32)).tobytes()
                                      ).hexdigest()}
    return rec, captured


def track_anything_phases(thresh, main_paths, captured):
    """The nets, then the main path twice with the card's nets in the
    model cache (two runs of one code, the same bits)."""
    from vipe_tpu_torch.models import model_cache
    from vipe_tpu_torch.priors.track_anything import TrackAnythingPipeline

    rec, ta = track_anything_nets_phase()
    print(json.dumps({"track_anything_nets": rec}), flush=True)
    key = ("track_anything", TrackAnythingPipeline, tuple(TA_PHRASES), (), "cuda")
    model_cache.cached_thread(key, lambda: TrackAnythingPipeline(
        TA_PHRASES, detector=ta["gdino"], tracker=ta["deaot"], segmentor=ta["sam"],
        device="cuda"))
    for label in ("track_anything", "track_anything_again"):
        main_paths[label], captured[label] = track_anything_main_path_phase(label, thresh)
        print(json.dumps({"main_path": main_paths[label]}), flush=True)
    model_cache.clear()


# ------------------------------------------------------------------ Metric3D

METRIC3D_NET_RTOL = 1e-3  # card against CPU, both IEEE f32, relative to the largest value
METRIC3D_PRIOR = "metric3d-large"  # slam.keyframe_depth of the Metric3D main paths
METRIC3D_ALIGN = "adaptive_metric3d-large_svda"  # the depth stage on its metric branch


def metric3d_net_phase():
    """Metric3D-small and -large at their published widths (DINOv2-reg
    ViT-S/L, the RAFT decoder with 4 / 8 refinement steps), seeded random
    weights, on a seeded normalised image at the canonical 616×1064: the
    card against the CPU in IEEE f32 (depth, normals, confidence), then the
    forward's time on the card by CUDA events, warm, against the operations
    ``torch.utils.flop_counter`` counts at the f32 peak.  The card's large
    model goes into the model cache, where the Metric3D main paths find
    it."""
    import torch

    from vipe_tpu_torch.models import model_cache
    from vipe_tpu_torch.priors.depth.metric3d import CANONICAL_SIZE, Metric3DModel
    from vipe_tpu_torch.utils.device import true_f32

    x = torch.randn((1, 3) + CANONICAL_SIZE, generator=torch.Generator().manual_seed(3))
    out = {"size": list(CANONICAL_SIZE), "precision": "f32 convolutions and matmuls, TF32 off",
           "tol": METRIC3D_NET_RTOL}
    for variant in ("small", "large"):
        model = Metric3DModel(variant, device="cuda")
        with torch.no_grad(), true_f32():
            ref = copy.deepcopy(model.net).cpu()(x)
            xc = x.cuda()
            got = model.net(xc)
            errs = {k: _rel_err(r, g) for k, r, g in zip(("depth", "normals", "confidence"),
                                                         ref, got)}
            if not max(errs.values()) <= METRIC3D_NET_RTOL:
                raise AssertionError(f"Metric3D-{variant} on the card against the CPU: {errs} "
                                     f"(limit {METRIC3D_NET_RTOL})")
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"Metric3D-{variant}: outputs not finite")
            timing = _net_timing(lambda: model.net(xc), F32_FLOPS_PER_S)
        out[variant] = {"rel_err": errs, "depth_range": [float(got[0].min()),
                                                          float(got[0].max())],
                        "params": sum(p.numel() for p in model.net.parameters()), **timing}
        del ref, got
        if variant == "large":
            model_cache.cached_global(("depth_model", Metric3DModel, METRIC3D_PRIOR, "cuda"),
                                      lambda: model)
        del model
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def metric3d_spy():
    """While active, counts the calls of Metric3D's ``estimate`` and keeps
    the SLAM buffers that a depth prior fills; yields the dict."""
    from vipe_tpu_torch.priors.depth.metric3d import Metric3DModel
    from vipe_tpu_torch.slam.buffer import GraphBuffer

    orig_est, orig_update = Metric3DModel.estimate, GraphBuffer.update_disps_sens
    seen = {"calls": 0, "buffers": []}

    def estimate(self, *args, **kwargs):
        seen["calls"] += 1
        return orig_est(self, *args, **kwargs)

    def update(self, depth_model, frame_idx=None):
        if not any(b is self for b in seen["buffers"]):
            seen["buffers"].append(self)
        return orig_update(self, depth_model, frame_idx)

    Metric3DModel.estimate, GraphBuffer.update_disps_sens = estimate, update
    try:
        yield seen
    finally:
        Metric3DModel.estimate, GraphBuffer.update_disps_sens = orig_est, orig_update


def metric3d_main_path_phase(label, thresh, keep=None):
    """``slam.keyframe_depth: metric3d-large`` (volume) on the seeded
    32-frame 720p stream: the prior runs on every keyframe (f32, the
    616×1064 canvas) and is rescaled by the focal ratio when the backend
    changes the focal.  Every keyframe's disparity prior must be finite and
    positive; records the prior's calls, the stage's host seconds and peak
    and the priors' bits."""
    import torch

    with metric3d_spy() as seen:
        rec, captured = main_path_phase(label, {"keyframe_depth": METRIC3D_PRIOR}, MAIN_FRAMES,
                                        thresh, ["corr_lookup"], keep=keep)
    if len(seen["buffers"]) != 1:
        raise AssertionError(f"{label}: the prior filled {len(seen['buffers'])} buffers")
    buf = seen["buffers"][0]
    sens = buf.disps_sens[:buf.n_frames]
    # once per appended keyframe (removed ones too), never again: the
    # backend's focal change rescales the priors
    if buf.n_frames != rec["keyframes"] or seen["calls"] < buf.n_frames or not (
            bool(torch.isfinite(sens).all()) and bool((sens > 0).all())):
        raise AssertionError(f"{label}: {seen['calls']} prior calls for {buf.n_frames} slots "
                             f"({rec['keyframes']} keyframes); priors finite and positive?")
    stage = rec["stages_host_s"]["keyframe_depth"]
    rec["keyframe_depth"] = {
        "model": METRIC3D_PRIOR, "prior_calls": seen["calls"], "stage_calls": stage["n"],
        "host_s": stage["s"], "peak_mem_gib": rec["stage_peak_mem_gib"]["keyframe_depth"],
        "prior_min": float(sens.min()), "prior_max": float(sens.max()),
        "prior_sha1": hashlib.sha1(sens.cpu().numpy().tobytes()).hexdigest()}
    del buf, sens, seen
    return rec, captured


def metric3d_depth_branch_phase(keep):
    """``AdaptiveDepthProcessor`` with ``adaptive_metric3d-large_svda``
    called on the first Metric3D main path's SLAM output and the seeded
    stream's frames (the SLAM intrinsics on each), the coverage threshold
    above any score so that the metric branch runs: Metric3D-large per
    frame, VDA-S aligned to it.  Every frame's depth must be finite and
    positive; records host seconds and peaks per stage."""
    import gc

    import torch

    from vipe_tpu_torch.pipeline.processors import AdaptiveDepthProcessor
    from vipe_tpu_torch.utils import profiling

    slam_out = keep["output"].payload["slam_output"]
    frames = []
    for f in synth_stream(MAIN_FRAMES):
        f.intrinsics = np.asarray(slam_out.intrinsics, np.float32)
        frames.append(f)
    gc.collect()
    torch.cuda.empty_cache()
    profiling.snapshot(reset=True)
    torch.cuda.reset_peak_memory_stats()
    with stage_peaks() as (peaks, top), metric3d_spy() as seen:
        proc = AdaptiveDepthProcessor(METRIC3D_ALIGN, slam_output=slam_out, coverage_thresh=2.0,
                                      device="cuda")
        t0 = time.perf_counter()
        depths = [f.metric_depth for f in proc.update_iterator(iter(frames))]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not proc.use_metric or seen["calls"] != MAIN_FRAMES:
        raise AssertionError(f"the metric branch did not run Metric3D on every frame "
                             f"(metric {proc.use_metric}, {seen['calls']} calls)")
    return {"model": METRIC3D_ALIGN, "branch": "metric", "coverage": proc.coverage,
            "coverage_thresh": 2.0, "metric3d_calls": seen["calls"], "frames": MAIN_FRAMES,
            "resolution": [MAIN_H, MAIN_W], "wall_s": wall, "fps": MAIN_FRAMES / wall,
            "peak_mem_gib": max(top[0], torch.cuda.max_memory_allocated()) / 2 ** 30,
            "stage_peak_mem_gib": peaks, "stages_host_s": profiling.snapshot(reset=True),
            "depth": _depths_record(depths, MAIN_FRAMES, "metric3d metric branch")}


# --------------------------------------------------- the last SLAM options


class ShiftTracker:
    """Sparse tracks for the seeded stream (``slam.sparse_tracks: {name:
    instance, instance: chip_smoke.ShiftTracker}``): a fixed grid of points
    on the stream's canvas, observed wherever the stream's known shift puts
    them in the frame, (5, 3) px a frame on the raw 720p frame, mapped
    through the SLAM resize and crop; points outside the frame are not
    observed, so tracks vanish and reappear as the crop wraps.  OpenCV's
    LK tracker, the built-in one, is held against the JAX package on the
    CPU; the card's machine need not have OpenCV."""

    enabled = True

    def __init__(self, n_views: int = 1):
        from vipe_tpu_torch.slam.sparse_tracks import SparseTracks

        self._tracks = SparseTracks(n_views)
        self.n_views = n_views
        gx, gy = np.meshgrid(np.linspace(20, MAIN_W + 44, 24), np.linspace(20, MAIN_H + 44, 14))
        self.points = np.stack([gx.ravel(), gy.ravel()], -1)

    def __getattr__(self, name):
        # the queries and the splat of the port's SparseTracks
        if name == "_tracks":
            raise AttributeError(name)
        return getattr(self._tracks, name)

    def track_image(self, frame_idx, frames):
        from vipe_tpu_torch.slam.system import StandardResizeStreamProcessor

        proc = StandardResizeStreamProcessor()
        (h1, w1), (top, _, left, _) = proc._compute((MAIN_H, MAIN_W))
        h, w = frames[0].rgb.shape[:2]
        raw = self.points - [(frame_idx * 5) % 64, (frame_idx * 3) % 64]
        uv = np.stack([(raw[:, 0] + 0.5) * w1 / MAIN_W - 0.5 - left,
                       (raw[:, 1] + 0.5) * h1 / MAIN_H - 0.5 - top], -1)
        inside = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        for v in range(self.n_views):
            for kp in np.flatnonzero(inside):
                self._tracks.add_observation(v, int(kp), frame_idx, uv[kp])


@contextlib.contextmanager
def options_spy():
    """While active, counts the BA's track rows that carry a weight (edge
    rows splatted with at least one keypoint) and keeps the inner filler's
    results; yields the dict."""
    from vipe_tpu_torch.slam import system
    from vipe_tpu_torch.slam.sparse_tracks import SparseTracks

    orig_splat, orig_result = (SparseTracks.compute_dense_disp_target_weight,
                               system.InnerFiller.get_result)
    seen = {"splat_calls": 0, "track_rows": 0, "filled": []}

    def splat(self, *args, **kwargs):
        target, weight = orig_splat(self, *args, **kwargs)
        seen["splat_calls"] += 1
        seen["track_rows"] += int((weight.reshape(len(weight), -1) > 0).any(1).sum())
        return target, weight

    def get_result(self):
        seen["filled"].append(orig_result(self))
        return seen["filled"][-1]

    SparseTracks.compute_dense_disp_target_weight = splat
    system.InnerFiller.get_result = get_result
    try:
        yield seen
    finally:
        SparseTracks.compute_dense_disp_target_weight = orig_splat
        system.InnerFiller.get_result = orig_result


def sparse_tracks_main_path_phase(label, thresh):
    """``slam.sparse_tracks`` (``ShiftTracker``) with ``slam.visualize:
    true`` (a snapshot every 4 keyframes, in a temporary directory) on the
    seeded 32-frame 720p stream, volume: the tracks join the motion
    filter's decision and the BA as a second flow term.  The BA must take
    track rows, and the snapshot must read back with the run's keyframes;
    records both."""
    import shutil
    import tempfile

    from vipe_tpu_torch.utils.telemetry import read_snapshot

    tmp = tempfile.mkdtemp(prefix="vipe_telemetry_")
    try:
        cfg = {"sparse_tracks": {"name": "instance", "instance": "chip_smoke.ShiftTracker"},
               "visualize": True, "visualize_path": tmp, "visualize_every": 4}
        with options_spy() as seen:
            rec, captured = main_path_phase(label, cfg, MAIN_FRAMES, thresh, ["corr_lookup"])
        snaps = sorted(p.name for p in pathlib.Path(tmp).iterdir())
        snap = read_snapshot(pathlib.Path(tmp) / snaps[0]) if snaps else {}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if seen["track_rows"] <= 0:
        raise AssertionError(f"{label}: the BA took no track rows ({seen['splat_calls']} splats)")
    if snaps != ["synth0_live.npz"] or int(snap["n_keyframes"]) != rec["keyframes"] or not (
            np.isfinite(snap["poses_w2c"]).all() and np.isfinite(snap["cloud_xyz"]).all()):
        raise AssertionError(f"{label}: snapshots {snaps}, "
                             f"{snap.get('n_keyframes')} keyframes in the last")
    rec["sparse_tracks"] = {"splat_calls": seen["splat_calls"], "track_rows": seen["track_rows"]}
    rec["snapshot"] = {"files": snaps, "n_keyframes": int(snap["n_keyframes"]),
                       "cloud_points": int(len(snap["cloud_xyz"]))}
    cfg["visualize_path"] = "<tmp>"
    rec["slam"] = cfg
    return rec, captured


def infill_alt_main_path_phase(label, thresh):
    """``slam.infill_dense_disp: true`` with ``corr_mode: alt`` on the seeded
    32-frame 720p stream: the filler solves every frame's disparities
    (volumes, as the JAX package's loop path builds them) beside the poses;
    K2 carries the frontend and backend.  Every frame must get a finite
    disparity map."""
    with options_spy() as seen:
        rec, captured = main_path_phase(label, {"infill_dense_disp": True, "corr_mode": "alt"},
                                        MAIN_FRAMES, thresh, ["corr_lookup", "corr_fused"])
    disps = seen["filled"][0].dense_disps if len(seen["filled"]) == 1 else None
    if disps is None or len(disps) != MAIN_FRAMES or not np.isfinite(disps).all():
        raise AssertionError(f"{label}: the filler's disparities "
                             f"{None if disps is None else disps.shape} are not one finite map "
                             "per frame")
    rec["dense_disps"] = {"shape": list(disps.shape), "min": float(disps.min()),
                          "max": float(disps.max())}
    return rec, captured


def slice11_phases(thresh, main_paths, captured):
    """Metric3D's nets, its keyframe-prior main path twice, the depth
    stage on its metric branch, the sparse-tracks path twice, the infill
    path once."""
    from vipe_tpu_torch.models import model_cache

    print(json.dumps({"metric3d_net": metric3d_net_phase()}), flush=True)
    keep = {}
    for label in ("metric3d", "metric3d_again"):
        main_paths[label], captured[label] = metric3d_main_path_phase(
            label, thresh, keep if label == "metric3d" else None)
        print(json.dumps({"main_path": main_paths[label]}), flush=True)
    print(json.dumps({"metric3d_depth_branch": metric3d_depth_branch_phase(keep)}), flush=True)
    del keep
    model_cache.clear()
    for label in ("sparse_tracks", "sparse_tracks_again"):
        main_paths[label], captured[label] = sparse_tracks_main_path_phase(label, thresh)
        print(json.dumps({"main_path": main_paths[label]}), flush=True)
    main_paths["infill_alt"], captured["infill_alt"] = infill_alt_main_path_phase("infill_alt",
                                                                                  thresh)
    print(json.dumps({"main_path": main_paths["infill_alt"]}), flush=True)


def determinism_check(main_paths):
    """Two runs of one main path in one call must agree: keyframes,
    removals and K1 launches equal, intrinsics and trajectory bit-equal."""
    out = {}
    for a, b in (("volume", "volume_again"), ("mei_masks_depth", "mei_masks_depth_again"),
                 ("unidepth", "unidepth_again"), ("depth_align", "depth_align_again"),
                 ("track_anything", "track_anything_again"), ("metric3d", "metric3d_again"),
                 ("sparse_tracks", "sparse_tracks_again")):
        ra, rb = main_paths[a], main_paths[b]
        same = {k: ra[k] == rb[k] for k in ("keyframes", "n_removals", "late_removals",
                                             "intrinsics_hex", "trajectory_sha1")}
        same["K1_launches"] = ra["launches"]["corr_lookup"] == rb["launches"]["corr_lookup"]
        if "depth_align" in ra:
            same["depth_sha1"] = (ra["depth_align"]["depth"]["sha1"]
                                  == rb["depth_align"]["depth"]["sha1"])
            same["branch"] = ra["depth_align"]["branch"] == rb["depth_align"]["branch"]
        if "track_anything" in ra:
            same["instance_sha1"] = (ra["track_anything"]["instance_sha1"]
                                     == rb["track_anything"]["instance_sha1"])
        if "keyframe_depth" in ra and "prior_sha1" in ra["keyframe_depth"]:
            same["prior_sha1"] = (ra["keyframe_depth"]["prior_sha1"]
                                  == rb["keyframe_depth"]["prior_sha1"])
        if "sparse_tracks" in ra:
            same["track_rows"] = ra["sparse_tracks"] == rb["sparse_tracks"]
        if not all(same.values()):
            raise AssertionError(f"runs {a} and {b} of one code differ: {same}")
        out[f"{a} / {b}"] = same
    return out


def depth_phases(thresh, main_paths, captured):
    """The depth stage's nets, then the depth main path twice (two runs of
    one code, the same bits), then the branch it did not take, then
    PriorDA's completion on the card against the CPU."""
    print(json.dumps({"depth_nets": depth_nets_phase()}), flush=True)
    for label in ("depth_align", "depth_align_again"):
        keep = {}
        main_paths[label], captured[label] = depth_main_path_phase(label, thresh, keep)
        print(json.dumps({"main_path": main_paths[label]}), flush=True)
    print(json.dumps({"depth_other_branch": depth_other_branch_phase(main_paths["depth_align"],
                                                                     keep)}), flush=True)
    print(json.dumps({"priorda_card_vs_cpu": priorda_card_vs_cpu_phase(keep["priorda_chunk"])}),
          flush=True)


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
    print(json.dumps({"oracle": rig_oracle_phase()}), flush=True)

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
        # the MEI run again: two runs of one code must give the same bits
        ("mei_masks_depth_again", {"camera_type": "mei", "keyframe_depth": "constant-2.0"},
         MAIN_FRAMES, ["corr_lookup"], {"stream_kw": mei, "init": {"intrinsics": "gt"}}),
    ]
    # the rig: 2 views, every frame edge expanded into one edge per view;
    # its filler keeps volumes in alt mode too, as the JAX package's does
    rig_thresh = calibrate_filter_thresh(rig_streams(MAIN_FRAMES)[0], MAIN_KEYFRAMES)
    runs += [
        ("rig_volume", {}, MAIN_FRAMES, ["corr_lookup"], {"rig": True}),
        ("rig_alt", {"corr_mode": "alt"}, MAIN_FRAMES, ["corr_fused"], {"rig": True}),
    ]
    main_paths, captured = {}, {}
    for label, cfg, n_frames, required, kw in runs:
        main_paths[label], captured[label] = main_path_phase(
            label, cfg, n_frames, rig_thresh if kw.get("rig") else thresh, required, **kw)
        print(json.dumps({"main_path": main_paths[label]}), flush=True)

    print(json.dumps({"unidepth_net": unidepth_net_phase()}), flush=True)
    # the UniDepth keyframe prior, twice: two runs of one code, the same bits
    for label in ("unidepth", "unidepth_again"):
        main_paths[label], captured[label] = unidepth_main_path_phase(label, thresh)
        print(json.dumps({"main_path": main_paths[label]}), flush=True)
    depth_phases(thresh, main_paths, captured)
    # the process keeps the factory's UniDepth-L (0.83 GiB on the card) and
    # the depth stage's models: drop them, so that the later paths' peaks
    # are their own
    from vipe_tpu_torch.models import model_cache

    model_cache.clear()
    track_anything_phases(thresh, main_paths, captured)
    slice11_phases(thresh, main_paths, captured)
    model_cache.clear()

    print(json.dumps({"determinism": determinism_check(main_paths)}), flush=True)
    print(json.dumps({"geocalib_lm": geocalib_lm_phase()}), flush=True)
    print(json.dumps({"geocalib_net": geocalib_net_phase()}), flush=True)
    main_paths["geocalib"], captured["geocalib"] = geocalib_main_path_phase()
    print(json.dumps({"main_path": main_paths["geocalib"]}), flush=True)

    k1["launches"] = main_paths["volume"]["launches"]["corr_lookup"]
    k1["geocalib_launches"] = main_paths["geocalib"]["launches"]["corr_lookup"]
    k1["unidepth_launches"] = main_paths["unidepth"]["launches"]["corr_lookup"]
    k1["depth_align_launches"] = main_paths["depth_align"]["launches"]["corr_lookup"]
    k1["track_anything_launches"] = main_paths["track_anything"]["launches"]["corr_lookup"]
    k1["metric3d_launches"] = main_paths["metric3d"]["launches"]["corr_lookup"]
    k1["sparse_tracks_launches"] = main_paths["sparse_tracks"]["launches"]["corr_lookup"]
    k1["infill_alt_launches"] = main_paths["infill_alt"]["launches"]["corr_lookup"]
    k2["infill_alt_launches"] = main_paths["infill_alt"]["launches"]["corr_fused"]
    k2["launches"] = main_paths["alt"]["launches"]["corr_fused"]
    k1["rig_launches"] = main_paths["rig_volume"]["launches"]["corr_lookup"]
    k2["rig_launches"] = main_paths["rig_alt"]["launches"]["corr_fused"]
    mainpath_coords_phase({"K1": (k1, captured["volume"]), "K2": (k2, captured["alt"])})
    mainpath_coords_phase({"K1": (k1, captured["rig_volume"]), "K2": (k2, captured["rig_alt"])},
                          key="rig_mainpath_coords")
    cross = cross_view_phase()
    k1["rig_cross_view"] = {m: c for m, c in cross.items() if m.startswith("volume")}
    k2["rig_cross_view"] = cross["alt_bf16"]
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
