#!/usr/bin/env python3
"""Write a seeded synthetic 720p clip and run the port's CLI on it, timed.

    python3 scripts/cli_clip.py [--frames 16] [--out DIR] [-- CLI ARGS...]

The clip is the textured canvas of ``chip_smoke.py``'s main path (shifted
(5, 3) px a frame) with two flat blocks of colour, as an mp4 (OpenCV).
Then ``python -m vipe_tpu_torch.cli.main infer CLIP --output DIR/out`` runs
with the arguments after ``--`` (``--pipeline full``, overrides); the
script prints one JSON line: the command, its exit code, wall seconds and
the artifact tree with each file's size.  It exits with the CLI's code.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 720, 1280


def write_clip(path: pathlib.Path, n_frames: int, fps: float = 30.0):
    import cv2

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (H + 64, W + 64, 3), dtype=np.uint8)
    base[100:400, 200:600] = (40, 40, 200)
    base[350:700, 700:1000] = (220, 60, 30)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for k in range(n_frames):
        ox, oy = (k * 5) % 64, (k * 3) % 64
        writer.write(base[oy: oy + H, ox: ox + W])
    writer.release()


def main():
    argv = sys.argv[1:]
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv[: argv.index("--")] if "--" in argv else argv)
    root = pathlib.Path(args.out or tempfile.mkdtemp())
    root.mkdir(parents=True, exist_ok=True)
    clip = root / "clip.mp4"
    write_clip(clip, args.frames)
    out = root / "out"
    cmd = [sys.executable, "-m", "vipe_tpu_torch.cli.main", "infer", str(clip), "--output",
           str(out)] + extra
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=pathlib.Path(__file__).resolve().parents[1]).returncode
    wall = time.perf_counter() - t0
    tree = {str(p.relative_to(out)): p.stat().st_size for p in sorted(out.rglob("*"))
            if p.is_file()} if out.exists() else {}
    print(json.dumps({"cli": cmd[1:], "frames": args.frames, "size": [H, W], "rc": rc,
                      "wall_s": wall, "artifacts": tree}), flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
