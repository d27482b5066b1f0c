#!/usr/bin/env python3
"""Which slots ``vipe_tpu``'s ``GraphBuffer.update_disps_sens`` reads and
writes for a rig (JAX on the CPU).

A 2-view buffer takes three keyframes whose images are filled with
``10·frame + view``; a probe prior returns, for each call, a map filled with
the value it read.  The buffer keeps a rig's per-view rows in slots
``frame·V + view``, but ``update_disps_sens(frame_idx=n_frames − 1)``
(called so by ``vipe_tpu/slam/system.py``) reads ``images[k]`` and writes
``disps_sens[k]`` at the frame number ``k``; after an intrinsics change it
reruns slots ``0 … n_frames − 1`` only.  The printout shows it.

    JAX_PLATFORMS=cpu python scripts/check_rig_keyframe_depth.py
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vipe_tpu.priors.depth.base import DepthType  # noqa: E402
from vipe_tpu.slam.buffer import GraphBuffer  # noqa: E402


class Probe:
    depth_type = DepthType.MODEL_METRIC_DEPTH

    def __init__(self):
        self.seen = []

    def estimate_sens_device(self, img, intr):
        val = int(img[0, 0, 0])
        self.seen.append(val)
        return jnp.full((img.shape[0] // 8, img.shape[1] // 8), float(val))


def main():
    V, H, W, n = 2, 16, 16, 3
    buf = GraphBuffer(H, W, buffer_size=8, n_views=V)
    feat = jnp.zeros((V, H // 8, W // 8, 128))
    probe = Probe()
    for f in range(n):
        img = jnp.stack([jnp.full((H, W, 3), 10 * f + v, jnp.uint8) for v in range(V)])
        buf.append_keyframe(f, img, feat, feat, feat,
                            intrinsics=np.array([[20.0, 20.0, 8.0, 8.0]] * V, np.float32))
        buf.update_disps_sens(probe, frame_idx=buf.n_frames - 1)
    print("image value = 10*frame + view, slot = frame*V + view")
    print("per keyframe, images read:", probe.seen,
          "(view 0 of each frame would be", [10 * f for f in range(n)], ")")
    print("disps_sens by slot:", [float(buf.disps_sens[s, 0, 0]) for s in range(n * V)])
    buf.intrinsics = buf.intrinsics * 1.1
    probe.seen.clear()
    buf.update_disps_sens(probe, frame_idx=None)
    print("after an intrinsics change, images read:", probe.seen, f"({n * V} slots hold frames)")


if __name__ == "__main__":
    main()
