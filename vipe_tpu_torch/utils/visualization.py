"""Visualization video (port of ``vipe_tpu/utils/visualization.py``): per
frame a row of panes (rgb, instance ids, colourised inverse depth, the
rectified frame, the SLAM map projected over the frame), written to an mp4.

OpenCV and matplotlib are imported only where a pane or the writer needs
them.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

# fixed instance palette; id 0 (the static scene) is black
_PALETTE = np.asarray(
    [[0, 0, 0],
     [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
     [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195]],
    np.uint8)


def colorize_instance(instance: np.ndarray) -> np.ndarray:
    return _PALETTE[np.asarray(instance) % len(_PALETTE)]


def colorize_inv_depth(depth: np.ndarray, q_lo=0.02, q_hi=0.98) -> np.ndarray:
    """Inverse depth through matplotlib's turbo map, stretched between its
    ``q_lo`` and ``q_hi`` quantiles; pixels without depth black."""
    import matplotlib

    d = np.asarray(depth, np.float32)
    inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-6), 0.0)
    valid = inv > 0
    if valid.any():
        lo, hi = np.quantile(inv[valid], [q_lo, q_hi])
        inv = np.clip((inv - lo) / max(hi - lo, 1e-6), 0, 1)
    out = (matplotlib.colormaps["turbo"](inv)[..., :3] * 255).astype(np.uint8)
    out[~valid] = 0
    return out


class VideoWriter:
    """mp4 (mp4v) writer of RGB frames, opened on the first frame."""

    def __init__(self, path, fps: float = 30.0):
        self.path = str(path)
        self.fps = fps
        self._writer = None

    def write(self, frame_rgb: np.ndarray):
        import cv2

        f = np.asarray(frame_rgb)
        if f.dtype != np.uint8:
            f = (np.clip(f, 0, 1) * 255).astype(np.uint8)
        if self._writer is None:
            h, w = f.shape[:2]
            pathlib.Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            self._writer = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps,
                                           (w, h))
        self._writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))

    def close(self):
        if self._writer is not None:
            self._writer.release()


def rectify_rgb(rgb8: np.ndarray, intrinsics, camera_type) -> np.ndarray:
    """The frame as its pinhole equivalent sees it: the pinhole grid
    unprojected at unit disparity, projected through the frame's own camera
    and sampled bilinearly (zero outside).  Identity for a pinhole."""
    import cv2

    from ..ops import cameras as cam

    ct = cam.CameraType(camera_type) if isinstance(camera_type, str) else camera_type
    if ct == cam.CameraType.PINHOLE:
        return rgb8
    h, w = rgb8.shape[:2]
    intr = torch.as_tensor(np.asarray(intrinsics, np.float32).reshape(-1))
    pin = cam.pinhole_equivalent(ct, intr)
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                          torch.arange(w, dtype=torch.float32), indexing="ij")
    pts = cam.iproj_disp(cam.CameraType.PINHOLE, pin, u, v, torch.ones((h, w)))
    coords = cam.proj_points(ct, intr, pts).numpy().astype(np.float32)
    return cv2.remap(rgb8, coords[..., 0], coords[..., 1], cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT)


def render_projection_frame(frame, k, slam_output, attributes=("rgb", "depth")) -> np.ndarray:
    """Frame ``k``'s panes side by side, in the order of ``attributes``:
    ``rgb``, ``depth`` (the frame's metric depth), ``instance``,
    ``rectified`` and ``pcd`` (the map's depth from the frame's pose,
    blended half and half with the frame)."""
    from ..ops import lie

    panes = []
    h, w = frame.size()
    rgb8 = (np.clip(frame.rgb, 0, 1) * 255).astype(np.uint8)
    for attr in attributes:
        if attr == "rgb":
            panes.append(rgb8)
        elif attr == "depth" and frame.metric_depth is not None:
            panes.append(colorize_inv_depth(frame.metric_depth))
        elif attr == "instance" and frame.instance is not None:
            panes.append(colorize_instance(frame.instance))
        elif attr == "rectified" and frame.intrinsics is not None:
            panes.append(rectify_rgb(rgb8, frame.intrinsics, slam_output.camera_type))
        elif attr == "pcd" and slam_output.slam_map is not None:
            w2c = lie.se3_inv(torch.as_tensor(
                np.asarray(slam_output.trajectory[k], np.float32))).numpy()
            depth = slam_output.slam_map.project_map(
                w2c, slam_output.intrinsics, slam_output.camera_type, (h, w), frame_idx=k)
            panes.append((0.5 * rgb8 + 0.5 * colorize_inv_depth(depth)).astype(np.uint8))
    return np.concatenate(panes or [rgb8], axis=1)
