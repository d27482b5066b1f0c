"""SLAM frontend: keyframe-incremental tracking (port of
``vipe_tpu/slam/frontend.py`` in its reference-exact ordering:
``keyframe_spec_depth: 1``, ``proximity_spec: false``).

Initialises after ``warmup`` keyframes; then, per new keyframe: age out old
edges, propose proximity edges, ``iters1`` GRU/BA rounds, drop the
second-newest keyframe if it moved too little (else ``iters2`` more
rounds), and predict the next slot with constant velocity.
"""

from __future__ import annotations

import torch

from ..ops import lie
from .factor_graph import FactorGraph


class SLAMFrontend:
    def __init__(self, buffer, update_fn, config):
        c = config
        if c.get("keyframe_spec_depth", 1) != 1:
            raise NotImplementedError("keyframe_spec_depth != 1 is not ported yet")
        if c.get("proximity_spec", False):
            raise NotImplementedError("proximity_spec: true is not ported yet")
        self.buffer = buffer
        self.graph = FactorGraph(
            buffer, update_fn, max_factors=48, incremental=True,
            optimize_intrinsics=c.get("optimize_intrinsics", False),
            corr_mode=c.get("corr_mode", "volume"),
            corr_dtype=c.get("corr_dtype", "bf16"),
        )
        self.t1 = 0
        self.is_initialized = False
        self.max_age = 25
        self.iters1 = 4
        self.iters2 = 2
        self.n_removals = 0
        self.warmup = c.get("warmup", 8)
        self.beta = c.get("beta", 0.3)
        self.frontend_nms = c.get("frontend_nms", 1)
        self.keyframe_thresh = c.get("keyframe_thresh", 4.0)
        self.frontend_window = c.get("frontend_window", 25)
        self.frontend_thresh = c.get("frontend_thresh", 16.0)
        self.frontend_radius = c.get("frontend_radius", 2)
        self.seq_init = c.get("seq_init", True)

    def _init_slot(self):
        """Constant-velocity pose and mean disparity for the next slot t1."""
        buf, t1 = self.buffer, self.t1
        p1, p2 = buf.poses[t1 - 2], buf.poses[t1 - 1]
        w = lie.se3_log(lie.se3_mul(p2, lie.se3_inv(p1))) * 0.5
        buf.poses[t1] = lie.se3_mul(lie.se3_exp(w), p2)
        buf.disps[t1] = buf.disps[t1 - 1].mean()

    def _update(self):
        """Per-new-keyframe update."""
        self.t1 += 1
        g = self.graph
        if g.n_edges > 0:
            g.rm_factors(g.age > self.max_age, store=True)
        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - self.frontend_window, 0),
            rad=self.frontend_radius, nms=self.frontend_nms,
            thresh=self.frontend_thresh, beta=self.beta, remove=True,
        )
        for _ in range(self.iters1):
            g.update(use_inactive=True)
        d = self.buffer.frame_distance(
            [self.t1 - 3], [self.t1 - 2], beta=self.beta
        )
        if float(torch.max(d)) < self.keyframe_thresh:
            self.n_removals += 1
            g.rm_keyframe(self.t1 - 2)
            self.t1 -= 1
        else:
            for _ in range(self.iters2):
                g.update(use_inactive=True)
        self._init_slot()

    def _initialize(self):
        """System initialisation over the first ``warmup`` keyframes."""
        g = self.graph
        buf = self.buffer
        self.t1 = buf.n_frames
        g.add_neighborhood_factors(0, self.t1, r=1 if self.seq_init else 3)
        for _ in range(8):
            g.update(t0=1, use_inactive=True)
        if not self.seq_init:
            g.add_proximity_factors(0, 0, rad=2, nms=2, thresh=self.frontend_thresh,
                                    remove=False)
            for _ in range(8):
                g.update(t0=1, use_inactive=True)
        t1 = self.t1
        p1, p2 = buf.poses[t1 - 2], buf.poses[t1 - 1]
        w = lie.se3_log(lie.se3_mul(p2, lie.se3_inv(p1))) * 0.5
        buf.poses[t1] = lie.se3_mul(lie.se3_exp(w), p2)
        buf.disps[t1] = buf.disps[t1 - 4: t1].mean()
        self.is_initialized = True
        g.rm_factors(g.ii < self.warmup - 4, store=True)

    def run(self):
        if not self.is_initialized and self.buffer.n_frames == self.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.buffer.n_frames:
            self._update()
