"""GraphBuffer: the keyframe state of the SLAM system (port of
``vipe_tpu/slam/buffer.py``).

Preallocated ``buffer_size`` slots on the device, updated in place; topology
bookkeeping (``n_frames``, timestamps) stays on the host in numpy.

A V-view rig (``n_views`` > 1) keeps one pose per frame and, per view, the
images, disparities and features in slots ``frame·V + view``; ``rig`` holds
each view's camera-to-rig SE3 (None for one view), ``intrinsics`` is (V, D), and
``cross_view_idx`` the (frame, view) target of each slot's cross-view edge
(a frame edge with ``ii == jj``).  With V = 1 every slot is its frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cameras as cam
from ..ops import geom, lie
from ..utils import profiling


def _depth_to_sens(depth):
    """Full-res metric depth → the 1/8-grid disparity prior (samples at
    [3::8, 3::8]; no depth stays 0)."""
    d = depth[..., 3::8, 3::8].float()
    return torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-8), d)


class GraphBuffer:
    def __init__(self, height: int, width: int, buffer_size: int = 1024,
                 init_disp: float = 1.0,
                 camera_type: cam.CameraType = cam.CameraType.PINHOLE,
                 dense_disp_alpha: float = 0.001, feat_dtype=torch.bfloat16,
                 device="cpu", n_views: int = 1, rig=None):
        assert height % 8 == 0 and width % 8 == 0
        self.height, self.width = height, width
        self.ht, self.wd = height // 8, width // 8
        self.camera_type = camera_type
        self.buffer_size = buffer_size
        self.init_disp = init_disp
        self.dense_disp_alpha = dense_disp_alpha
        self.device = torch.device(device)
        self.n_views = V = n_views
        self.n_frames = 0
        self.tstamp = np.zeros(buffer_size, np.int64)

        B, ht, wd, dev = buffer_size * V, self.ht, self.wd, self.device
        self.images = torch.zeros((B, height, width, 3), dtype=torch.uint8, device=dev)
        self.poses = lie.se3_identity((buffer_size,), device=dev)
        if camera_type == cam.CameraType.PANORAMA:
            # the equirect camera follows from the frame size; the stream's
            # all-zero panorama intrinsics are ignored
            self.intrinsics = cam.panorama_intrinsics(height, width, device=dev)
        else:
            self.intrinsics = torch.zeros((camera_type.intrinsics_dim(),), device=dev)
        if V > 1:
            self.intrinsics = self.intrinsics.expand(V, -1).clone()
        # a single view keeps no rig: its chain is the frame's own pose
        self.rig = None
        if V > 1:
            self.rig = (lie.se3_identity((V,), device=dev) if rig is None else
                        torch.tensor(np.asarray(rig), dtype=torch.float32,
                                     device=dev).reshape(V, 7))
        # default cross-view target of slot (frame, view): (frame, view + 1)
        self.cross_view_idx = np.stack(np.broadcast_arrays(
            np.arange(buffer_size)[:, None], (np.arange(V)[None, :] + 1) % V), axis=-1).copy()
        self.disps = torch.full((B, ht, wd), init_disp, device=dev)
        self.disps_sens = torch.zeros((B, ht, wd), device=dev)
        self.masks = torch.zeros((B, ht, wd), dtype=torch.bool, device=dev)  # True = invalid
        self.fmaps = torch.zeros((B, ht, wd, 128), dtype=feat_dtype, device=dev)
        self.nets = torch.zeros((B, ht, wd, 128), dtype=feat_dtype, device=dev)
        self.inps = torch.zeros((B, ht, wd, 128), dtype=feat_dtype, device=dev)
        # intrinsics the keyframe depth prior last ran with
        self.last_depth_intrinsics = None
        # the keypoint tracks whose flow joins the BA (slam/sparse_tracks.py)
        self.sparse_tracks = None

    # ------------------------------------------------------------------ state

    @property
    def scaled_intrinsics(self):
        """Intrinsics at the 1/8 SLAM grid."""
        return cam.scaled_intrinsics(self.camera_type, self.intrinsics, 1.0 / 8.0)

    @property
    def pinhole_grid_intrinsics(self):
        return cam.pinhole_equivalent(self.camera_type, self.intrinsics) / 8.0

    def append_keyframe(self, frame_idx: int, image, fmap, net, inp, mask=None,
                        metric_depth=None, intrinsics=None, pose=None):
        """Fill the next frame.  ``image`` (H, W, 3) uint8 or float in
        [0, 1]; ``mask`` (ht, wd) bool, True = invalid; ``metric_depth``
        full-res, sampled at [3::8, 3::8] into the disparity prior; ``pose``
        a given world-to-camera pose (of the rig base); ``net``/``inp`` may
        be None when the row is never read.  A rig's per-view arguments
        carry a leading V axis, its ``intrinsics`` are (V, D)."""
        k = self.n_frames
        assert k < self.buffer_size, "keyframe buffer exhausted"
        self.tstamp[k] = frame_idx
        V = self.n_views
        rows = k if V == 1 else slice(k * V, (k + 1) * V)
        img = torch.as_tensor(image, device=self.device)
        if img.dtype != torch.uint8:
            img = torch.clamp(img * 255.0, 0, 255).to(torch.uint8)
        self.images[rows] = img
        self.fmaps[rows] = fmap
        if net is not None:
            self.nets[rows] = net
        if inp is not None:
            self.inps[rows] = inp
        if mask is not None:
            self.masks[rows] = mask
        if metric_depth is not None:
            self.disps_sens[rows] = _depth_to_sens(torch.as_tensor(
                np.asarray(metric_depth), dtype=torch.float32, device=self.device))
        if intrinsics is not None and k == 0 and self.camera_type != cam.CameraType.PANORAMA:
            # a copy: the caller's array must not alias the refined intrinsics
            self.intrinsics = torch.tensor(
                np.asarray(intrinsics), dtype=torch.float32, device=self.device
            ).reshape(self.intrinsics.shape)
        if pose is not None:
            self.poses[k] = torch.as_tensor(np.asarray(pose), dtype=torch.float32,
                                            device=self.device)
        self.n_frames += 1

    def append_keyframe_copy(self, src_frame: int, frame_idx: int):
        """Append a frame as a copy of an existing frame's rows (pass 2
        re-adds every frame; pass-1 keyframes are already encoded)."""
        k = self.n_frames
        V = self.n_views
        assert k < self.buffer_size and src_frame < k
        self.tstamp[k] = frame_idx
        for name in ("images", "fmaps", "nets", "inps", "masks", "disps_sens"):
            arr = getattr(self, name)
            if V == 1:
                arr[k] = arr[src_frame]
            else:
                arr[k * V:(k + 1) * V] = arr[src_frame * V:(src_frame + 1) * V]
        self.n_frames += 1

    def remove_slot(self, ix: int, top: int = None):
        """Remove keyframe row ``ix``, shifting rows (ix, top] down by one.

        ``top`` defaults to ``n_frames - 1``.  The speculative frontend
        removes a keyframe after a younger one was appended and passes the
        initialised next slot above ``n_frames`` as ``top``, so that slot
        shifts down too.  (The JAX package shifts a power of two of rows;
        the rows it moves beyond ``top`` are written before they are
        read.)"""
        top = self.n_frames - 1 if top is None else top
        assert top > ix
        V = self.n_views
        assert V == 1 or top == self.n_frames - 1, "a late removal is single-view only"
        self.poses[ix:top] = self.poses[ix + 1: top + 1].clone()
        for name in ("images", "disps", "disps_sens", "masks", "fmaps", "nets", "inps"):
            arr = getattr(self, name)
            arr[ix * V:top * V] = arr[(ix + 1) * V:(top + 1) * V].clone()
        if V > 1:
            cv = self.cross_view_idx
            cv[ix] = cv[ix + 1]
            # frames above the removed one move down; only live rows, the
            # rows past n_frames keep their same-frame defaults
            f = cv[: self.n_frames, :, 0]
            f[f >= ix + 1] -= 1
            # the vacated last frame reverts to its same-frame default
            last = self.n_frames - 1
            cv[last, :, 0] = last
            cv[last, :, 1] = (np.arange(V) + 1) % V
        self.tstamp[ix:top] = self.tstamp[ix + 1: top + 1]
        self.n_frames -= 1

    # --------------------------------------------------------------- geometry

    def reproject(self, ii, jj):
        """Coords of frame-ii grids in frame jj: (E, ht, wd, 2), valid
        (single view; a rig reprojects expanded edges, ``reproject_exp``)."""
        return geom.reproject(self.poses, self.disps, self.scaled_intrinsics,
                              self.camera_type, self._idx(ii), self._idx(jj))

    def reproject_exp(self, exp):
        """Coords of expanded edges, (E, 5) rows ``pi, qi, di, pj, qj``
        (single view: the frame edges ``pi → pj``)."""
        if self.n_views == 1:
            return self.reproject(exp[:, 0], exp[:, 3])
        pi, qi, di, pj, qj = (self._idx(exp[:, c]) for c in range(5))
        return geom.reproject_mv(self.poses, self.rig, self.disps, self.scaled_intrinsics,
                                 self.camera_type, pi, qi, di, pj, qj)

    def frame_distance(self, ii, jj, beta: float = 0.3):
        """Mean induced-flow distance of (ii → jj) with disp ii, averaged
        with (jj → ii) with disp jj.  For a rig, the (E·V,) distances of
        each edge's views, edge-major."""
        ii, jj = self._idx(ii), self._idx(jj)
        intr = self.pinhole_grid_intrinsics
        V = self.n_views
        if V > 1:
            pi, pj = ii.repeat_interleave(V), jj.repeat_interleave(V)
            q = torch.arange(V, device=self.device).repeat(len(ii))
            d = geom.frame_distance_mv(self.poses, self.rig, self.disps, intr,
                                       pi, q, pi * V + q, pj, q, beta=beta)
            d2 = geom.frame_distance_mv(self.poses, self.rig, self.disps, intr,
                                        pj, q, pj * V + q, pi, q, beta=beta)
            return 0.5 * (d + d2)
        d = geom.frame_distance(self.poses, self.disps, intr, ii, jj, di=ii, beta=beta)
        d2 = geom.frame_distance(self.poses, self.disps, intr, jj, ii, di=jj, beta=beta)
        return 0.5 * (d + d2)

    # -------------------------------------------------------------- multiview

    def expand_edge_multiview(self, ii, jj, cross: bool = True):
        """Frame edges → expanded (frame, view) edges ``(pi, qi, di, pj, qj,
        dj)``, V per frame edge, edge-major; with ``cross`` an ``ii == jj``
        edge targets ``cross_view_idx`` instead of its own view."""
        V = self.n_views
        ii = np.asarray(ii, np.int64).reshape(-1, 1)
        jj = np.asarray(jj, np.int64).reshape(-1, 1)
        qi = np.broadcast_to(np.arange(V), (len(ii), V)).copy()
        pi = np.broadcast_to(ii, (len(ii), V)).copy()
        qj = qi.copy()
        pj = np.broadcast_to(jj, (len(jj), V)).copy()
        if cross and V > 1:
            cm = (ii == jj)[:, 0]
            if cm.any():
                tv = self.cross_view_idx[pi[cm], qi[cm]]
                pj[cm] = tv[..., 0]
                qj[cm] = tv[..., 1]
        di = pi * V + qi
        dj = pj * V + qj
        return tuple(a.reshape(-1) for a in (pi, qi, di, pj, qj, dj))

    def _expanded_with_offset(self, ii, jj, view_offset: int):
        pi, qi, di, pj, qj, dj = self.expand_edge_multiview(ii, jj, cross=False)
        qj = (qj + view_offset) % self.n_views
        return pi, qi, di, pj, qj, pj * self.n_views + qj

    def build_adaptive_cross_view_idx(self, valid_thresh: float = 400.0):
        """Point each slot's cross-view edge at the (frame, other view) with
        the smallest induced flow, where that flow is under
        ``valid_thresh``."""
        V, n = self.n_views, self.n_frames
        if V == 1 or n < 2:
            return
        intr = self.pinhole_grid_intrinsics
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        best_d = np.full((n, V), np.inf)
        best = np.zeros((n, V, 2), np.int64)
        for off in range(1, V):
            pi, qi, di, pj, qj, _ = self._expanded_with_offset(ii, jj, off)
            d = geom.frame_distance_mv(
                self.poses, self.rig, self.disps, intr, self._idx(pi), self._idx(qi),
                self._idx(di), self._idx(pj), self._idx(qj), beta=1.0,
            ).cpu().numpy().reshape(n, n, V)
            for f in range(n):
                for v in range(V):
                    k = int(np.argmin(d[f, :, v]))
                    if d[f, k, v] < best_d[f, v]:
                        best_d[f, v] = d[f, k, v]
                        best[f, v] = (k, (v + off) % V)
        upd = best_d < valid_thresh
        self.cross_view_idx[:n][upd] = best[upd]

    def _idx(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    def update_disps_sens(self, depth_model, frame_idx=None):
        """Run the keyframe depth prior: on slot ``frame_idx``, or, after the
        intrinsics changed, on every keyframe.  A metric-depth prior is
        rescaled by the focal ratio instead of run again."""
        if depth_model is None:
            return
        from ..priors.depth.base import DepthType

        if frame_idx is None:
            last = self.last_depth_intrinsics
            if last is not None and bool(torch.allclose(last, self.intrinsics)):
                return
            if depth_model.depth_type == DepthType.METRIC_DEPTH and last is not None:
                ratio = float(last[0]) / float(self.intrinsics[0])
                self.disps_sens[: self.n_frames] *= ratio
                self.last_depth_intrinsics = self.intrinsics.clone()
                return
            frames = range(self.n_frames)
        else:
            frames = [frame_idx]
        intr_row = self.intrinsics if self.intrinsics.ndim == 1 else self.intrinsics[0]
        on_device = hasattr(depth_model, "estimate_sens_device")
        for k in frames:
            with profiling.stage("keyframe_depth"):
                if on_device:
                    # image → disparity prior on the device, the focal read
                    # there from the live intrinsics: no host round trip
                    self.disps_sens[k] = depth_model.estimate_sens_device(self.images[k], intr_row)
                else:
                    depth = depth_model.estimate_depth(self.images[k].float() / 255.0,
                                                       focal_length=float(intr_row[0]))
                    self.disps_sens[k] = _depth_to_sens(torch.as_tensor(depth, device=self.device))
        self.last_depth_intrinsics = self.intrinsics.clone()

    # ---------------------------------------------------------------- mapping

    def extract_slam_map(self, filter_thresh: float, view: int = 0):
        """Depth-consistent coloured point cloud of the keyframes; for a rig,
        of view ``view``'s slots, with its camera poses ``rig[view]⁻¹·T``."""
        from .interface import SLAMMap

        n, V = self.n_frames, self.n_views
        if V == 1:
            poses, disps = self.poses[:n], self.disps[:n]
            images, masks, intr = self.images[:n], self.masks[:n], self.intrinsics
        else:
            slots = torch.arange(n, device=self.device) * V + view
            poses = lie.se3_mul(lie.se3_inv(self.rig[view]).expand(n, 7), self.poses[:n])
            disps, images, masks = self.disps[slots], self.images[slots], self.masks[slots]
            intr = self.intrinsics[view]
        ht, wd = self.ht, self.wd
        intr_grid = cam.scaled_intrinsics(self.camera_type, intr, 1.0 / 8.0)
        u, v = geom.pixel_grid(ht, wd, device=self.device)
        c2w = lie.se3_inv(poses)
        pts_local = cam.iproj_disp(self.camera_type, intr_grid, u, v, disps)
        pts_world = geom.act_homog(c2w[:, None, None, :], pts_local)
        xyz = pts_world[..., :3] / torch.clamp(pts_world[..., 3:], min=1e-8)
        colors = images[:, 3::8, 3::8, :].float() / 255.0

        mean_disp = disps.mean()
        thresh = filter_thresh / torch.clamp(mean_disp, min=1e-8)
        counts = geom.depth_filter(
            poses, disps, cam.pinhole_equivalent(self.camera_type, intr) / 8.0,
            torch.arange(n, device=self.device), thresh.expand(n),
        )
        per_frame_mean = disps.mean(dim=(1, 2), keepdim=True)
        mask = (counts >= min(2, n - 1)) & (disps > 0.5 * per_frame_mean) & ~masks
        return SLAMMap(
            xyz=xyz.cpu().numpy(),
            rgb=colors.cpu().numpy(),
            mask=mask.cpu().numpy(),
            frame_inds=self.tstamp[:n].copy(),
        )
