"""Pass-2 interpolation of non-keyframe poses (port of
``vipe_tpu/slam/inner_filler.py``).

Non-keyframes are appended after ``start_idx``; each chunk gets a
constant-velocity SE3 initialisation between its bracketing keyframes,
then 10 motion-only GRU/BA rounds against those two keyframes.  The rounds
run as the JAX package's ``_compute_loop`` does them; the correlation
state follows the path the JAX package takes with a real update network:
for one view without sparse tracks and without ``infill_dense_disp`` its
``_compute_fused``, ``corr_mode`` from the config (packed features in alt
mode) and bf16 volumes whatever ``corr_dtype`` says; else its
``_compute_loop``, volumes in ``corr_dtype`` whatever ``corr_mode`` says.
A rig fills its V slots of each frame.

With ``infill_dense_disp`` the chunk's disparities are solved too: they
start from each frame's sensor prior where it has one, else from its first
keyframe's mean disparity; reverse factors (chunk frame → each bracketing
keyframe) join the graph, the rounds update the chunk's disparities
(``limited_disp``), and ``FilledReturn.dense_disps`` returns them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops import lie
from .factor_graph import FactorGraph


@dataclass
class FilledReturn:
    poses: np.ndarray  # (T, 7) world-to-camera SE3 per original frame
    # (T·V, ht, wd) disparities of every slot, with infill_dense_disp
    dense_disps: Optional[np.ndarray] = None


class InnerFiller:
    def __init__(self, buffer, update_fn, config):
        self.buffer = buffer
        self.update_fn = update_fn
        self.config = config
        self.infill_disp = config.get("infill_dense_disp", False)
        self.start_idx = -1
        self.filled_poses: List[np.ndarray] = []
        self.filled_disps: List[np.ndarray] = []

    @property
    def needs_context(self) -> bool:
        """Whether a chunk frame's context features are read: only the
        reverse factors of ``infill_dense_disp`` take a chunk frame as
        their source."""
        return self.infill_disp

    def set_start_idx(self, start_idx: int):
        self.start_idx = start_idx

    def check(self) -> bool:
        assert self.start_idx >= 0
        return (self.buffer.n_frames - self.start_idx
                >= self.config.get("infill_chunk_size", 16))

    def compute(self):
        buf = self.buffer
        total = buf.n_frames
        s = self.start_idx
        m_t = buf.tstamp[s:total]
        n_t = buf.tstamp[:s]
        t0 = np.clip(np.searchsorted(n_t, m_t, side="right") - 1, 0, s - 1)
        t1 = np.where(t0 < s - 1, t0 + 1, t0)

        dev = buf.device
        d_time = torch.as_tensor((n_t[t1] - n_t[t0]).astype(np.float32) + 1e-3, device=dev)
        t0_t = torch.as_tensor(t0, device=dev)
        t1_t = torch.as_tensor(t1, device=dev)
        poses_kf = buf.poses[:s]
        dp = lie.se3_mul(poses_kf[t1_t], lie.se3_inv(poses_kf[t0_t]))
        vel = lie.se3_log(dp) / d_time[:, None]
        w = vel * torch.as_tensor((m_t - n_t[t0]).astype(np.float32), device=dev)[:, None]
        buf.poses[s:total] = lie.se3_mul(lie.se3_exp(w), poses_kf[t0_t])

        V = buf.n_views
        if self.infill_disp:
            t0v = torch.as_tensor((t0[:, None] * V + np.arange(V)).reshape(-1), device=dev)
            rows = slice(s * V, total * V)
            init = buf.disps[t0v].mean((1, 2), keepdim=True).expand_as(buf.disps[rows])
            sens = buf.disps_sens[rows]
            buf.disps[rows] = torch.where(sens > 0, sens, init)

        tracks = buf.sparse_tracks
        if V == 1 and not self.infill_disp and (tracks is None or not tracks.enabled):
            corr = {"corr_mode": self.config.get("corr_mode", "volume")}
        else:
            corr = {"corr_dtype": self.config.get("corr_dtype", "bf16")}
        graph = FactorGraph(buf, self.update_fn, max_factors=4 * (total - s),
                            incremental=True, **corr)
        infill = np.arange(s, total)
        graph.add_factors(t0, infill)
        graph.add_factors(t1, infill)
        if self.infill_disp:
            graph.add_factors(infill, t0)
            graph.add_factors(infill, t1)
        for _ in range(10):
            graph.update(t0=s, t1=total, motion_only=not self.infill_disp, limited_disp=True)
        self.filled_poses.append(buf.poses[s:total].cpu().numpy().copy())
        if self.infill_disp:
            self.filled_disps.append(buf.disps[s * V:total * V].cpu().numpy().copy())
        buf.n_frames = s

    def get_result(self) -> FilledReturn:
        return FilledReturn(
            poses=np.concatenate(self.filled_poses, axis=0),
            dense_disps=np.concatenate(self.filled_disps, axis=0) if self.filled_disps else None)
