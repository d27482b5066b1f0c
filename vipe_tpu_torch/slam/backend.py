"""SLAM backend: global BA over a freshly built proximity graph (port of
``vipe_tpu/slam/backend.py``)."""

from __future__ import annotations

import torch

from .factor_graph import FactorGraph


class SLAMBackend:
    def __init__(self, buffer, update_fn, config, depth_model=None):
        self.buffer = buffer
        self.update_fn = update_fn
        self.config = config
        self.depth_model = depth_model
        self.last_residual = 0.0

    def run(self, steps: int = 12, update_depth: bool = True):
        """Fresh graph over all keyframes + ``steps`` × update_batch.  With a
        keyframe depth prior, ``update_depth`` and intrinsics optimised, the
        prior runs again between the two halves, on the refined
        intrinsics, and the second half keeps the intrinsics fixed."""
        c = self.config
        buf = self.buffer
        t = buf.n_frames
        # alt: each chunk packs features instead of building its volumes;
        # the graph stores no corr state, so corr_dtype does not apply
        graph = FactorGraph(
            buf, self.update_fn, max_factors=16 * t, incremental=False,
            corr_mode=c.get("corr_mode", "volume"),
        )
        graph.add_proximity_factors(
            rad=c.get("backend_radius", 2), nms=c.get("backend_nms", 3),
            thresh=c.get("backend_thresh", 22.0), beta=c.get("beta", 0.3),
        )
        optimize_intrinsics = c.get("optimize_intrinsics", False)
        itrs = 16 if optimize_intrinsics else 8
        if graph.n_edges > 0:
            if self.depth_model is not None and update_depth and optimize_intrinsics:
                pre = steps // 2
                graph.update_batch(itrs=itrs, steps=pre, optimize_intrinsics=True)
                buf.update_disps_sens(self.depth_model, frame_idx=None)
                graph.update_batch(itrs=itrs, steps=steps - pre, optimize_intrinsics=False)
            else:
                graph.update_batch(itrs=itrs, steps=steps,
                                   optimize_intrinsics=optimize_intrinsics)
            self.last_residual = graph.current_residual()
        else:
            # single keyframe: adopt the sensor depth where there is one
            buf.disps[0] = torch.where(buf.disps_sens[0] > 0, buf.disps_sens[0], buf.disps[0])

    def run_if_necessary(self, steps: int = 12):
        if self.config.get("optimize_intrinsics", False):
            self.run(steps=steps, update_depth=True)
