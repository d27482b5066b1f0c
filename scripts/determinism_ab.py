#!/usr/bin/env python3
"""Run-to-run repeatability of the port's main paths on one CUDA card.

    python3 scripts/determinism_ab.py --root DIR [--runs volume,mei,...]
        [--deterministic-mode] [--out FILE]

Imports ``chip_smoke`` and ``vipe_tpu_torch`` from the checkout at ``DIR``
(so two checkouts can be compared in one call on one card), builds the
kernels, calibrates the motion-filter threshold as ``chip_smoke.py`` does,
and drives the named main paths of ``chip_smoke.py`` in order on its seeded
32-frame 720p stream: ``volume`` (the default config) and ``mei`` (the MEI
camera with the stream's intrinsics, masks and the constant keyframe depth
prior).  Prints, per run, keyframes, removals, K1 launches, the
intrinsics, a SHA-1 of the trajectory's and the intrinsics' bytes, fps and
the backend's host seconds; then, per path, whether all its runs gave the
same bits.

``--deterministic-mode`` sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before
CUDA starts and turns on ``torch.use_deterministic_algorithms(True,
warn_only=True)``; the ops it warned about are listed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import sys
import warnings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--runs", default="volume,mei,mei,volume")
    ap.add_argument("--deterministic-mode", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.deterministic_mode:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    import chip_smoke as cs

    cs._require_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    caught = []
    if args.deterministic_mode:
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.simplefilter("always")
        warnings.showwarning = lambda msg, *a, **k: caught.append(str(msg))

    from vipe_tpu_torch.ops import _build
    from vipe_tpu_torch.pipeline import default as pipeline_default

    _build.build_all()
    outputs = []
    orig_run = pipeline_default.DefaultAnnotationPipeline.run

    def run(self, stream):
        out = orig_run(self, stream)
        outputs.append(out)
        return out

    pipeline_default.DefaultAnnotationPipeline.run = run
    thresh = cs.calibrate_filter_thresh(cs.synth_stream(cs.MAIN_FRAMES), cs.MAIN_KEYFRAMES)
    mei = {"intrinsics": cs.MEI_INTRINSICS, "mask_rows": cs.MAIN_H // 6}
    paths = {
        "volume": ({}, {}),
        "mei": ({"camera_type": "mei", "keyframe_depth": "constant-2.0"},
                {"stream_kw": mei, "init": {"intrinsics": "gt"}}),
    }
    records = []
    for label in args.runs.split(","):
        cfg, kw = paths[label]
        rec, _ = cs.main_path_phase(label, cfg, cs.MAIN_FRAMES, thresh, ["corr_lookup"], **kw)
        out = outputs[-1]
        digest = hashlib.sha1(np.ascontiguousarray(out.trajectory).tobytes()
                              + np.ascontiguousarray(out.intrinsics).tobytes()).hexdigest()
        row = {"label": label, "keyframes": rec["keyframes"], "removed": rec["n_removals"],
               "late_removed": rec["late_removals"],
               "K1_launches": rec["launches"]["corr_lookup"],
               "intrinsics": [float(v).hex() for v in np.asarray(out.intrinsics).ravel()],
               "intrinsics_px": rec["intrinsics"], "sha1": digest,
               "fps": rec["fps"], "wall_s": rec["wall_s"],
               "backend_host_s": rec["stages_host_s"].get("slam_backend", {}).get("s")}
        records.append(row)
        print(json.dumps(row), flush=True)
    same = {}
    for label in dict.fromkeys(r["label"] for r in records):
        rows = [r for r in records if r["label"] == label]
        same[label] = all(
            (r["keyframes"], r["removed"], r["K1_launches"], r["sha1"])
            == (rows[0]["keyframes"], rows[0]["removed"], rows[0]["K1_launches"], rows[0]["sha1"])
            for r in rows)
    summary = {"root": str(root), "deterministic_mode": args.deterministic_mode,
               "filter_thresh": thresh, "bit_equal_runs": same,
               "flagged_ops": sorted(set(caught)), "card": cs._card_line()}
    print(json.dumps(summary), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": records, **summary}, f, indent=1)


if __name__ == "__main__":
    main()
