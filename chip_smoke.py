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
4. checks the SLAM machinery on the card against ground truth: a tiny
   synthetic scene whose update operator is a geometric oracle (GT flow,
   unit weights) must give back the GT trajectory;
5. drives the main path: a seeded synthetic 720p stream through
   ``DefaultAnnotationPipeline`` on ``cuda`` (random DroidNet weights from a
   seed), with the kernels' launch counts set to 0 just before and read
   just after; prints frames, keyframes, wall seconds, fps, peak memory;
6. prints the ``kernels`` JSON line and, last, the ``ok`` JSON line.

It exits non-zero without a result when no CUDA card is present, and in a
directory that does not hold the ``vipe_tpu_torch`` package.
"""

from __future__ import annotations

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

MAIN_FRAMES = 32
MAIN_KEYFRAMES = 12  # about one frame in three, the rate trained weights give on footage
MAIN_H, MAIN_W = 720, 1280
FRONTEND_EDGES = 48  # FactorGraph max_factors of the frontend


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


def _cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
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


# ------------------------------------------------------- oracle (ground truth)


def oracle_phase():
    """Tiny synthetic scene, geometric-oracle update operator, on the card:
    the recovered camera-to-world translations must match ground truth."""
    import torch

    from vipe_tpu_torch.ops import cameras as cam
    from vipe_tpu_torch.ops import geom, lie
    from vipe_tpu_torch.slam import system as slam_system
    from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream

    H, W, T, depth = 48, 64, 12, 2.0
    ht, wd = H // 8, W // 8
    rng = np.random.default_rng(3)
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
    intr_full = np.asarray([W * 1.2, W * 1.2, W / 2.0, H / 2.0], np.float32)
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
    I_grid = torch.as_tensor(intr_full / 8.0, device=dev)
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
        gt_coords, gt_valid = geom.reproject(P, D, I_grid, cam.CameraType.PINHOLE, fi, fj)
        delta = gt_coords - coords1
        weight = gt_valid[..., None].float().expand_as(delta)
        return net, delta, weight, torch.full((num_frames, ht, wd), 0.01, device=dev)

    def zeros(images):
        return torch.zeros((images.shape[0], ht, wd, 128), dtype=torch.bfloat16, device=dev)

    orig = slam_system.GraphBuffer
    slam_system.GraphBuffer = SpyBuffer
    try:
        out = slam_system.SLAMSystem(
            config=dict(resize_area=H * W, filter_thresh=-1.0, keyframe_thresh=0.0,
                        warmup=4, buffer=64, infill_chunk_size=6, backend_iters=12),
            device="cuda", update_fn=oracle, encode_features=zeros,
            encode_context=lambda im: (zeros(im), zeros(im)),
        ).run(Scene())
    finally:
        slam_system.GraphBuffer = orig
    err = np.sqrt(np.mean(np.sum((out.trajectory[:, :3] - gt_c2w[:, :3].numpy()) ** 2, -1)))
    if not (out.trajectory.shape == (T, 7) and np.isfinite(out.trajectory).all() and err < 0.02):
        raise AssertionError(f"oracle SLAM on the card: translation RMSE {err} (limit 0.02)")
    return {"frames": T, "keyframes": len(out.keyframes), "translation_rmse": float(err),
            "limit": 0.02}


# ------------------------------------------------------------------ main path


def synth_stream(n_frames: int, h: int = MAIN_H, w: int = MAIN_W, seed: int = 0):
    """A textured canvas translated frame by frame (real flow, no parallax),
    made from ``seed``."""
    from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream

    rng = np.random.default_rng(seed)
    base = rng.random((h + 64, w + 64, 3)).astype(np.float32)

    class Synth(VideoStream):
        _name = f"synth{seed}"

        def __len__(self):
            return n_frames

        def frame_size(self):
            return (h, w)

        def attributes(self):
            return {FrameAttribute.RGB}

        def __iter__(self):
            for k in range(n_frames):
                ox, oy = (k * 5) % 64, (k * 3) % 64
                yield VideoFrame(raw_frame_idx=k, rgb=base[oy: oy + h, ox: ox + w])

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


def main_path_phase(counters):
    import torch

    from vipe_tpu_torch.pipeline.default import DefaultAnnotationPipeline
    from vipe_tpu_torch.utils import profiling

    stream = synth_stream(MAIN_FRAMES)
    thresh = calibrate_filter_thresh(stream, MAIN_KEYFRAMES)
    pipe = DefaultAnnotationPipeline(
        init={"intrinsics": "fov", "fov_deg": 60.0},
        slam={"optimize_intrinsics": True, "filter_thresh": thresh},
        output={"path": None}, device="cuda", return_payload=True,
    )
    profiling.snapshot(reset=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = pipe.run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    stages = profiling.snapshot(reset=True)

    slam_out = out.payload["slam_output"]
    traj = np.asarray(out.trajectory)
    if traj.shape != (MAIN_FRAMES, 7) or not np.isfinite(traj).all():
        raise AssertionError(f"main path: trajectory {traj.shape} not finite / wrong shape")
    if not np.isfinite(out.intrinsics).all() or out.intrinsics.shape != (4,):
        raise AssertionError(f"main path: intrinsics {out.intrinsics}")
    quat_norm = np.linalg.norm(traj[:, 3:], axis=-1)
    if not np.allclose(quat_norm, 1.0, atol=1e-3):
        raise AssertionError("main path: rotations are not unit quaternions")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path did not launch {name}")
    return {
        "frames": MAIN_FRAMES, "resolution": [MAIN_H, MAIN_W],
        "keyframes": int(len(slam_out.keyframes)), "filter_thresh": thresh,
        "wall_s": wall, "fps": MAIN_FRAMES / wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches,
        "stages_host_s": stages,
        "intrinsics": [float(x) for x in out.intrinsics],
        "ba_residual": float(out.ba_residual),
    }


def main():
    _require_environment()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(_card_line(), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)

    from vipe_tpu_torch.ops import _build
    from vipe_tpu_torch.ops import corr_kernels as ck

    t0 = time.perf_counter()
    built = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "libraries": [p.name for p in built]}), flush=True)

    k1 = kernel_phase()
    print(json.dumps({"kernel_check": k1["cases"]}), flush=True)
    print(json.dumps({"oracle": oracle_phase()}), flush=True)

    main_path = main_path_phase([ck.corr_lookup])
    print(json.dumps({"main_path": main_path}), flush=True)

    k1["launches"] = main_path["launches"]["corr_lookup"]
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
