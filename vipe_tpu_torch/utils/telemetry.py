"""Live SLAM telemetry (port of ``vipe_tpu/utils/telemetry.py``).

With ``slam.visualize: true`` the SLAM system writes a polled snapshot
file: every ``visualize_every`` keyframes (and once after the global BA)
the writer reads the live keyframe trajectory and the newest keyframe's
1/8-grid disparity and image back from the device, builds a preview cloud
on the host and atomically replaces ``<dir>/<name>_live.npz``.  Any other
process can read a consistent snapshot at any time (``read_snapshot``).

The preview cloud uses the pinhole-equivalent intrinsics for every camera
model: it is a monitoring aid, not an output; the exact clouds come from
``GraphBuffer.extract_slam_map`` at the end of the run.
"""

from __future__ import annotations

import os
import pathlib
import time

import numpy as np
import torch

from ..ops import lie


class TelemetryWriter:
    def __init__(self, out_dir, name: str = "slam", every: int = 8):
        self.dir = pathlib.Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.every = max(int(every), 1)
        self._last_n = 0

    @property
    def snapshot_path(self) -> pathlib.Path:
        return self.dir / f"{self.name}_live.npz"

    def update(self, buffer, force: bool = False) -> bool:
        """Write a snapshot if ``every`` new keyframes arrived (or forced).
        Returns True when a snapshot was written."""
        n = buffer.n_frames
        if n == 0 or (not force and n - self._last_n < self.every):
            return False
        self._last_n = n

        last_slot = (n - 1) * buffer.n_views  # the newest keyframe, view 0
        poses_w2c = buffer.poses[:n].float().cpu().numpy()  # per-frame rig-base w2c
        disp = buffer.disps[last_slot].float().cpu().numpy()
        rgb = buffer.images[last_slot].cpu().numpy()
        fx, fy, cx, cy = buffer.pinhole_grid_intrinsics.reshape(-1, 4)[0].float().cpu().numpy()

        ht, wd = disp.shape
        u, v = np.meshgrid(np.arange(wd, dtype=np.float32), np.arange(ht, dtype=np.float32))
        z = 1.0 / np.clip(disp, 1e-4, None)
        pts_cam = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1).reshape(-1, 3)
        cols = rgb[::max(rgb.shape[0] // ht, 1),
                   ::max(rgb.shape[1] // wd, 1)][:ht, :wd].reshape(-1, 3)

        # camera → world with the newest keyframe's pose (w2c stored)
        m = np.linalg.inv(lie.se3_matrix(torch.from_numpy(poses_w2c[n - 1])).numpy())
        pts_w = pts_cam @ m[:3, :3].T + m[:3, 3]
        keep = (disp.reshape(-1) > 1e-3) & np.isfinite(pts_w).all(-1)

        tmp = self.snapshot_path.with_name(self.snapshot_path.name + ".tmp")
        with open(tmp, "wb") as f:  # a file handle: savez appends no ".npz"
            np.savez(
                f,
                n_keyframes=np.int64(n),
                tstamp=np.asarray(buffer.tstamp[:n]),
                poses_w2c=poses_w2c,
                cloud_xyz=pts_w[keep].astype(np.float32),
                cloud_rgb=cols[keep],
                wall_time=np.float64(time.time()),
            )
        os.replace(tmp, self.snapshot_path)
        return True


def read_snapshot(path) -> dict:
    """Load a snapshot written by ``TelemetryWriter``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
