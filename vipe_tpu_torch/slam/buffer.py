"""GraphBuffer: the keyframe state of the SLAM system (port of
``vipe_tpu/slam/buffer.py``, single view).

Preallocated ``buffer_size`` slots on the device, updated in place; topology
bookkeeping (``n_frames``, timestamps) stays on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cameras as cam
from ..ops import geom, lie


class GraphBuffer:
    def __init__(self, height: int, width: int, buffer_size: int = 1024,
                 init_disp: float = 1.0,
                 camera_type: cam.CameraType = cam.CameraType.PINHOLE,
                 dense_disp_alpha: float = 0.001, feat_dtype=torch.bfloat16,
                 device="cpu"):
        assert height % 8 == 0 and width % 8 == 0
        cam.require_pinhole(camera_type)
        self.height, self.width = height, width
        self.ht, self.wd = height // 8, width // 8
        self.camera_type = camera_type
        self.buffer_size = buffer_size
        self.init_disp = init_disp
        self.dense_disp_alpha = dense_disp_alpha
        self.device = torch.device(device)
        self.n_frames = 0
        self.tstamp = np.zeros(buffer_size, np.int64)

        B, ht, wd, dev = buffer_size, self.ht, self.wd, self.device
        self.images = torch.zeros((B, height, width, 3), dtype=torch.uint8, device=dev)
        self.poses = lie.se3_identity((B,), device=dev)
        self.intrinsics = torch.zeros((camera_type.intrinsics_dim(),), device=dev)
        self.disps = torch.full((B, ht, wd), init_disp, device=dev)
        self.disps_sens = torch.zeros((B, ht, wd), device=dev)
        self.masks = torch.zeros((B, ht, wd), dtype=torch.bool, device=dev)  # True = invalid
        self.fmaps = torch.zeros((B, ht, wd, 128), dtype=feat_dtype, device=dev)
        self.nets = torch.zeros((B, ht, wd, 128), dtype=feat_dtype, device=dev)
        self.inps = torch.zeros((B, ht, wd, 128), dtype=feat_dtype, device=dev)

    # ------------------------------------------------------------------ state

    @property
    def scaled_intrinsics(self):
        """Intrinsics at the 1/8 SLAM grid."""
        return cam.scaled_intrinsics(self.camera_type, self.intrinsics, 1.0 / 8.0)

    @property
    def pinhole_grid_intrinsics(self):
        return cam.pinhole_equivalent(self.camera_type, self.intrinsics) / 8.0

    def append_keyframe(self, frame_idx: int, image, fmap, net, inp, mask=None,
                        metric_depth=None, intrinsics=None):
        """Fill the next slot.  ``image`` (H, W, 3) uint8 or float in [0, 1];
        ``metric_depth`` full-res, sampled at [3::8, 3::8] into the disparity
        prior; ``net``/``inp`` may be None when the row is never read."""
        k = self.n_frames
        assert k < self.buffer_size, "keyframe buffer exhausted"
        self.tstamp[k] = frame_idx
        img = torch.as_tensor(image, device=self.device)
        if img.dtype != torch.uint8:
            img = torch.clamp(img * 255.0, 0, 255).to(torch.uint8)
        self.images[k] = img
        self.fmaps[k] = fmap
        if net is not None:
            self.nets[k] = net
        if inp is not None:
            self.inps[k] = inp
        if mask is not None:
            self.masks[k] = mask
        if metric_depth is not None:
            d = torch.as_tensor(np.asarray(metric_depth), dtype=torch.float32,
                                device=self.device)[3::8, 3::8]
            self.disps_sens[k] = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-8), d)
        if intrinsics is not None and k == 0:
            self.intrinsics = torch.as_tensor(
                np.asarray(intrinsics), dtype=torch.float32, device=self.device
            ).reshape(self.intrinsics.shape)
        self.n_frames += 1

    def append_keyframe_copy(self, src_frame: int, frame_idx: int):
        """Append a slot as a copy of an existing frame's rows (pass 2
        re-adds every frame; pass-1 keyframes are already encoded)."""
        k = self.n_frames
        assert k < self.buffer_size and src_frame < k
        self.tstamp[k] = frame_idx
        for name in ("images", "fmaps", "nets", "inps", "masks", "disps_sens"):
            arr = getattr(self, name)
            arr[k] = arr[src_frame]
        self.n_frames += 1

    def remove_slot(self, ix: int):
        """Remove keyframe row ``ix``, shifting rows (ix, n_frames) down."""
        top = self.n_frames - 1
        assert top > ix
        for name in ("poses", "images", "disps", "disps_sens", "masks",
                     "fmaps", "nets", "inps"):
            arr = getattr(self, name)
            arr[ix:top] = arr[ix + 1: top + 1].clone()
        self.tstamp[ix:top] = self.tstamp[ix + 1: top + 1]
        self.n_frames -= 1

    # --------------------------------------------------------------- geometry

    def reproject(self, ii, jj):
        """Coords of frame-ii grids in frame jj: (E, ht, wd, 2), valid."""
        return geom.reproject(self.poses, self.disps, self.scaled_intrinsics,
                              self.camera_type, self._idx(ii), self._idx(jj))

    def frame_distance(self, ii, jj, beta: float = 0.3):
        """Mean induced-flow distance of (ii → jj) with disp ii, averaged
        with (jj → ii) with disp jj."""
        ii, jj = self._idx(ii), self._idx(jj)
        intr = self.pinhole_grid_intrinsics
        d = geom.frame_distance(self.poses, self.disps, intr, ii, jj, di=ii, beta=beta)
        d2 = geom.frame_distance(self.poses, self.disps, intr, jj, ii, di=jj, beta=beta)
        return 0.5 * (d + d2)

    def _idx(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    # ---------------------------------------------------------------- mapping

    def extract_slam_map(self, filter_thresh: float):
        """Depth-consistent coloured point cloud of the keyframes."""
        from .interface import SLAMMap

        n = self.n_frames
        poses, disps = self.poses[:n], self.disps[:n]
        ht, wd = self.ht, self.wd
        intr_grid = self.scaled_intrinsics
        u, v = geom.pixel_grid(ht, wd, device=self.device)
        c2w = lie.se3_inv(poses)
        pts_local = cam.iproj_disp(self.camera_type, intr_grid, u, v, disps)
        pts_world = geom.act_homog(c2w[:, None, None, :], pts_local)
        xyz = pts_world[..., :3] / torch.clamp(pts_world[..., 3:], min=1e-8)
        colors = self.images[:n, 3::8, 3::8, :].float() / 255.0

        mean_disp = disps.mean()
        thresh = filter_thresh / torch.clamp(mean_disp, min=1e-8)
        counts = geom.depth_filter(
            poses, disps, self.pinhole_grid_intrinsics,
            torch.arange(n, device=self.device), thresh.expand(n),
        )
        per_frame_mean = disps.mean(dim=(1, 2), keepdim=True)
        mask = (counts >= min(2, n - 1)) & (disps > 0.5 * per_frame_mean) & ~self.masks[:n]
        return SLAMMap(
            xyz=xyz.cpu().numpy(),
            rgb=colors.cpu().numpy(),
            mask=mask.cpu().numpy(),
            frame_inds=self.tstamp[:n].copy(),
        )
