"""Sparse keypoint tracks (port of ``vipe_tpu/slam/sparse_tracks.py``).

``SparseTracks`` keeps per-(view, frame) keypoint observations.  The motion
filter reads them (the mean keypoint flow, and a keyframe forced when more
than a fifth of the tracks vanish), and the BA splats them onto the 1/8
grid as a second flow term (``compute_dense_disp_target_weight``, host
numpy, as the JAX package computes it: when two keypoints fall in one cell
the last write wins).  ``build_sparse_tracks`` makes the backend that
``slam.sparse_tracks`` names:

* ``dummy`` (the default): disabled;
* ``lk``: ``LKSparseTracks``, Shi-Tomasi corners and OpenCV's pyramidal
  Lucas-Kanade with a forward-backward check, on the host (OpenCV is
  imported where it runs);
* ``instance``: a tracker class given by its dotted path
  (``instance: module.Class``), built with the section's other keys.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class SparseTracks:
    enabled: bool = True

    def __init__(self, n_views: int = 1):
        self.n_views = n_views
        # view → keypoint id → frame → (u, v) at full resolution
        self.observations: List[Dict[int, Dict[int, np.ndarray]]] = [
            {} for _ in range(n_views)
        ]

    # ------------------------------------------------------------- tracking

    def track_image(self, frame_idx: int, frames: Sequence) -> None:
        """Ingest one frame per view (``SLAMSystem``'s pass 1 calls it on
        every frame)."""
        raise NotImplementedError

    def add_observation(self, view_idx: int, kp_id: int, frame_idx: int,
                        uv) -> None:
        self.observations[view_idx].setdefault(kp_id, {})[frame_idx] = (
            np.asarray(uv, np.float32)
        )

    # --------------------------------------------------------------- queries

    def get_correspondences(self, view_idx: int, frame_i: int,
                            frame_j: int) -> List[int]:
        """Keypoint ids observed in both frames of a view."""
        return [
            k for k, obs in self.observations[view_idx].items()
            if frame_i in obs and frame_j in obs
        ]

    def get_observations(self, view_idx: int, frame_idx: int,
                         kp_ids: List[int]) -> np.ndarray:
        obs = self.observations[view_idx]
        return np.stack(
            [obs[k][frame_idx] for k in kp_ids]
        ) if kp_ids else np.zeros((0, 2), np.float32)

    def n_tracks(self, view_idx: int, frame_idx: int) -> int:
        return sum(
            1 for obs in self.observations[view_idx].values()
            if frame_idx in obs
        )

    # ---------------------------------------------------------- BA coupling

    def compute_dense_disp_target_weight(
        self,
        source_view_inds: np.ndarray,
        source_frame_inds: np.ndarray,
        target_view_inds: np.ndarray,
        target_frame_inds: np.ndarray,
        image_size: Tuple[int, int],
        dense_disp_size: Tuple[int, int],
        weight: float = 1.0,
    ):
        """Splat keypoint correspondences onto the 1/8 grid as extra BA flow
        targets: for each edge and each keypoint observed in both frames,
        the grid cell containing the source observation gets target = the
        target-frame observation (scaled to grid coords) and ``weight``;
        all other cells get weight 0.  Same-view edges only.
        """
        H, W = image_size
        ht, wd = dense_disp_size
        E = len(source_frame_inds)
        target = np.zeros((E, ht, wd, 2), np.float32)
        wgt = np.zeros((E, ht, wd, 2), np.float32)
        sx, sy = wd / W, ht / H
        for e in range(E):
            qi, qj = int(source_view_inds[e]), int(target_view_inds[e])
            if qi != qj:
                continue
            fi, fj = int(source_frame_inds[e]), int(target_frame_inds[e])
            kps = self.get_correspondences(qi, fi, fj)
            if not kps:
                continue
            src = self.get_observations(qi, fi, kps)
            dst = self.get_observations(qj, fj, kps)
            gu = np.clip((src[:, 0] * sx).astype(int), 0, wd - 1)
            gv = np.clip((src[:, 1] * sy).astype(int), 0, ht - 1)
            target[e, gv, gu, 0] = dst[:, 0] * sx
            target[e, gv, gu, 1] = dst[:, 1] * sy
            wgt[e, gv, gu] = weight
        return target, wgt


class DummySparseTracks(SparseTracks):
    """Disabled backend, the default."""

    enabled = False

    def track_image(self, frame_idx: int, frames) -> None:
        pass


class LKSparseTracks(SparseTracks):
    """Host-side tracker: Shi-Tomasi corners + pyramidal Lucas-Kanade with
    a forward-backward consistency check.  Persistent keypoint ids per
    view, whose observations feed the BA splat term and the motion
    filter's track-attrition keyframe forcing; corners are detected again
    when fewer than ``redetect_ratio·max_corners`` tracks survive."""

    def __init__(self, n_views: int = 1, max_corners: int = 200,
                 quality_level: float = 0.01, min_distance: int = 8,
                 fb_thresh: float = 1.5, redetect_ratio: float = 0.7):
        super().__init__(n_views)
        self.max_corners = max_corners
        self.quality_level = quality_level
        self.min_distance = min_distance
        self.fb_thresh = fb_thresh
        self.redetect_ratio = redetect_ratio
        self._prev_gray: List[Optional[np.ndarray]] = [None] * n_views
        self._active: List[Dict[int, np.ndarray]] = [
            {} for _ in range(n_views)
        ]
        self._next_id = 0

    def _to_gray(self, frame) -> np.ndarray:
        import cv2

        rgb = np.asarray(frame.rgb)
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        return cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)

    def _detect(self, gray: np.ndarray, view: int, frame_idx: int) -> None:
        import cv2

        mask = np.full(gray.shape, 255, np.uint8)
        for uv in self._active[view].values():
            cv2.circle(mask, (int(uv[0]), int(uv[1])),
                       self.min_distance, 0, -1)
        want = self.max_corners - len(self._active[view])
        if want <= 0:
            return
        pts = cv2.goodFeaturesToTrack(
            gray, maxCorners=want, qualityLevel=self.quality_level,
            minDistance=self.min_distance, mask=mask,
        )
        if pts is None:
            return
        for p in pts.reshape(-1, 2):
            kp_id = self._next_id
            self._next_id += 1
            self._active[view][kp_id] = np.asarray(p, np.float32)
            self.add_observation(view, kp_id, frame_idx, p)

    def track_image(self, frame_idx: int, frames: Sequence) -> None:
        import cv2

        for v in range(self.n_views):
            gray = self._to_gray(frames[v])
            prev = self._prev_gray[v]
            active = self._active[v]
            if prev is not None and active:
                ids = list(active.keys())
                p0 = np.stack([active[k] for k in ids]).reshape(-1, 1, 2)
                p1, st, _ = cv2.calcOpticalFlowPyrLK(prev, gray, p0, None)
                # forward-backward check kills drifting tracks
                p0b, stb, _ = cv2.calcOpticalFlowPyrLK(gray, prev, p1, None)
                fb = np.linalg.norm(
                    (p0 - p0b).reshape(-1, 2), axis=-1
                )
                ok = (
                    (st.reshape(-1) == 1) & (stb.reshape(-1) == 1)
                    & (fb < self.fb_thresh)
                )
                h, w = gray.shape
                uv1 = p1.reshape(-1, 2)
                inside = (
                    (uv1[:, 0] >= 0) & (uv1[:, 0] < w)
                    & (uv1[:, 1] >= 0) & (uv1[:, 1] < h)
                )
                ok &= inside
                self._active[v] = {}
                for k, keep, uv in zip(ids, ok, uv1):
                    if keep:
                        self._active[v][k] = uv.astype(np.float32)
                        self.add_observation(v, k, frame_idx, uv)
            if (
                prev is None
                or len(self._active[v])
                < self.redetect_ratio * self.max_corners
            ):
                self._detect(gray, v, frame_idx)
            self._prev_gray[v] = gray


def build_sparse_tracks(config: Optional[dict] = None,
                        n_views: int = 1) -> SparseTracks:
    """The tracker that a ``slam.sparse_tracks`` section names."""
    name = (config or {}).get("name", "dummy")
    if name == "dummy":
        return DummySparseTracks(n_views)
    if name == "lk":
        kwargs = {k: v for k, v in (config or {}).items() if k != "name"}
        return LKSparseTracks(n_views=n_views, **kwargs)
    if name == "instance":
        # dotted-path custom tracker: instance=module.Class
        import importlib

        path = config["instance"]
        module, cls = path.rsplit(".", 1)
        klass = getattr(importlib.import_module(module), cls)
        kwargs = {k: v for k, v in config.items()
                  if k not in ("name", "instance")}
        return klass(n_views=n_views, **kwargs)
    raise ValueError(
        f"unknown sparse tracks backend {name!r}: use 'dummy', 'lk' "
        "(OpenCV pyramidal LK), or 'instance' with a dotted path"
    )
