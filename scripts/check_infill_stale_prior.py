#!/usr/bin/env python3
"""Which disparity prior a pass-2 frame without depth carries in
``vipe_tpu``'s SLAM buffer (JAX on the CPU).

Pass 1 leaves three keyframes (frames 0, 2, 4) whose priors are filled with
``frame + 1``.  Pass 2 appends every frame in chunks after them, as
``vipe_tpu/slam/system.py`` does: a keyframe as a copy of its slot (the
prior copied), any other frame by ``append_keyframe`` without
``metric_depth`` (the slot's prior not written); after each chunk the
filler sets ``n_frames`` back to the chunk's start, so the next chunk
reuses the same slots.  The printout shows each pass-2 frame's slot and
the prior it then holds: frames of the second chunk that are not
keyframes hold the prior of whatever frame the first chunk left in their
slot.  With ``slam.infill_dense_disp`` the filler starts those frames'
disparities from that prior and holds them to it in the BA
(``vipe_tpu/slam/inner_filler.py`` ``_compute_loop``).

    JAX_PLATFORMS=cpu python scripts/check_infill_stale_prior.py
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vipe_tpu.slam.buffer import GraphBuffer  # noqa: E402

H, W = 48, 64
KEYFRAMES = (0, 2, 4)
CHUNK = 3  # frames per pass-2 chunk


def main():
    buf = GraphBuffer(height=H, width=W, buffer_size=16)
    feat = np.zeros((H // 8, W // 8, 128), np.float32)
    intr = np.asarray([70.0, 70.0, W / 2, H / 2], np.float32)
    for frame in KEYFRAMES:
        buf.append_keyframe(frame, jnp.zeros((H, W, 3), jnp.uint8), feat, feat, feat,
                            intrinsics=intr.copy(),
                            metric_depth=np.full((H, W), 1.0 / (frame + 1), np.float32))
    start = buf.n_frames
    for chunk0 in range(0, 6, CHUNK):
        for frame in range(chunk0, chunk0 + CHUNK):
            if frame in KEYFRAMES:
                buf.append_keyframe_copy(KEYFRAMES.index(frame), frame)
            else:
                buf.append_keyframe(frame, jnp.zeros((H, W, 3), jnp.uint8), feat, None, None)
            slot = buf.n_frames - 1
            prior = float(buf.disps_sens[slot].mean())
            own = frame + 1 if frame in KEYFRAMES else 0  # a frame without depth has none
            print(f"frame {frame}: slot {slot}, keyframe {frame in KEYFRAMES}, "
                  f"prior {prior:g}, its own {own}")
        buf.n_frames = start  # the filler's reset after each chunk


if __name__ == "__main__":
    main()
