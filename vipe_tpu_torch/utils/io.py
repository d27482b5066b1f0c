"""Artifact I/O (port of ``vipe_tpu/utils/io.py``); the on-disk layout is
byte-compatible with the JAX package's, so its readers (and
``python -m vipe_tpu.cli.main evaluate``) read what this module writes.

Layout under an output root, per video ``<name>``:
  rgb/<name>.mp4                processed RGB video
  pose/<name>.npz               {"data": (T, 4, 4) c2w matrices, "inds": (T,)}
  intrinsics/<name>.npz         {"data": (T, D)} + intrinsics/<name>_camera.txt
  depth/<name>.zip              per-frame float16 EXR "Z" entries "%05d.exr"
  mask/<name>.zip               per-frame PNG instance masks + mask/<name>.txt
  vipe/<name>_info.pkl          misc info (ba_residual, …)
  vipe/<name>_vis.mp4           the visualization video (output.save_viz)

OpenCV is imported only by the rgb-video and mask-PNG writers/readers.
"""

from __future__ import annotations

import dataclasses
import io as _io
import pathlib
import pickle
import zipfile
from typing import Iterator, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ArtifactPath:
    root: pathlib.Path
    name: str

    def __post_init__(self):
        self.root = pathlib.Path(self.root)

    @property
    def rgb_path(self):
        return self.root / "rgb" / f"{self.name}.mp4"

    @property
    def pose_path(self):
        return self.root / "pose" / f"{self.name}.npz"

    @property
    def intrinsics_path(self):
        return self.root / "intrinsics" / f"{self.name}.npz"

    @property
    def camera_type_path(self):
        return self.root / "intrinsics" / f"{self.name}_camera.txt"

    @property
    def depth_path(self):
        return self.root / "depth" / f"{self.name}.zip"

    @property
    def mask_path(self):
        return self.root / "mask" / f"{self.name}.zip"

    @property
    def mask_phrase_path(self):
        return self.root / "mask" / f"{self.name}.txt"

    @property
    def info_path(self):
        return self.root / "vipe" / f"{self.name}_info.pkl"

    @property
    def vis_path(self):
        return self.root / "vipe" / f"{self.name}_vis.mp4"

    def exists(self) -> bool:
        return self.pose_path.exists()


# ------------------------------------------------------------------ writers


def se3_to_matrix(poses: np.ndarray) -> np.ndarray:
    """(N, 7) ``[t, q(xyzw)]`` → (N, 4, 4)."""
    from ..ops import lie

    return lie.se3_matrix(torch.as_tensor(np.asarray(poses, np.float32))).numpy()


def save_poses(path: ArtifactPath, trajectory_c2w: np.ndarray, inds=None):
    """trajectory: (T, 7) SE3 or (T, 4, 4) matrices."""
    path.pose_path.parent.mkdir(parents=True, exist_ok=True)
    mats = trajectory_c2w if trajectory_c2w.ndim == 3 else se3_to_matrix(trajectory_c2w)
    if inds is None:
        inds = np.arange(len(mats))
    np.savez(path.pose_path, data=mats.astype(np.float32), inds=np.asarray(inds))


def save_intrinsics(path: ArtifactPath, intrinsics: np.ndarray, camera_type: str,
                    n_frames: Optional[int] = None):
    path.intrinsics_path.parent.mkdir(parents=True, exist_ok=True)
    intr = np.asarray(intrinsics, np.float32)
    if intr.ndim == 1 and n_frames is not None:
        intr = np.broadcast_to(intr, (n_frames,) + intr.shape)
    np.savez(path.intrinsics_path, data=intr)
    path.camera_type_path.write_text(str(camera_type))


def save_info(path: ArtifactPath, info: dict):
    path.info_path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.info_path, "wb") as f:
        pickle.dump(info, f)


def _open_video_writer(path: str, fps: float, size):
    """h264 (avc1) where the OpenCV build supports it, else mp4v."""
    import cv2

    quiet = getattr(getattr(cv2, "utils", None), "logging", None)
    prev = quiet.getLogLevel() if quiet else None
    try:
        if quiet:
            quiet.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
        for fourcc in ("avc1", "mp4v"):
            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, size)
            if w.isOpened():
                return w
            w.release()
    finally:
        if quiet:
            quiet.setLogLevel(prev)
    raise RuntimeError(f"no usable mp4 encoder for {path}")


class StreamingArtifactWriter:
    """Incremental per-frame artifact writer: rgb video, depth zip and mask
    zip entries are written as frames arrive.  Zip archives stay dense:
    once any depth/mask entry exists, every frame index gets one (NaN depth
    / zero mask fill-ins, backfilled when the first value arrives late)."""

    def __init__(self, path: ArtifactPath, fps: float = 30.0,
                 write_rgb: bool = True, write_depth: bool = True,
                 write_mask: bool = True):
        self.path = path
        self.fps = fps
        self.write_rgb = write_rgb
        self.write_depth = write_depth
        self.write_mask = write_mask
        self._rgb_writer = None
        self._depth_zip = None
        self._mask_zip = None
        self._depth_shape = None
        self._mask_shape = None
        self.n_frames = 0
        self.wrote_depth = False
        self.wrote_mask = False

    def _put_depth(self, i: int, depth):
        from .exr import encode_exr

        self._depth_zip.writestr(f"{i:05d}.exr", encode_exr(depth))

    def _put_mask(self, i: int, mask):
        import cv2

        ok, png = cv2.imencode(".png", np.asarray(mask, np.uint8))
        assert ok
        self._mask_zip.writestr(f"{i:05d}.png", png.tobytes())

    def _put_rgb(self, rgb):
        import cv2

        f = np.asarray(rgb)
        if f.dtype != np.uint8:
            f = (np.clip(f, 0, 1) * 255).astype(np.uint8)
        if self._rgb_writer is None:
            self.path.rgb_path.parent.mkdir(parents=True, exist_ok=True)
            h, w = f.shape[:2]
            self._rgb_writer = _open_video_writer(str(self.path.rgb_path), self.fps, (w, h))
        self._rgb_writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))

    def add_frame(self, rgb=None, depth=None, instance=None):
        i = self.n_frames
        if rgb is not None and self.write_rgb:
            self._put_rgb(rgb)
        if self.write_depth and (depth is not None or self._depth_zip is not None):
            if depth is not None and self._depth_zip is None:
                self.path.depth_path.parent.mkdir(parents=True, exist_ok=True)
                self._depth_zip = zipfile.ZipFile(self.path.depth_path, "w", zipfile.ZIP_DEFLATED)
                fill = np.full(np.asarray(depth).shape, np.nan, np.float16)
                for k in range(i):
                    self._put_depth(k, fill)
            if depth is None:
                depth = np.full(self._depth_shape, np.nan, np.float16)
            self._depth_shape = np.asarray(depth).shape
            self._put_depth(i, depth)
            self.wrote_depth = True
        if self.write_mask and (instance is not None or self._mask_zip is not None):
            if instance is not None and self._mask_zip is None:
                self.path.mask_path.parent.mkdir(parents=True, exist_ok=True)
                self._mask_zip = zipfile.ZipFile(self.path.mask_path, "w", zipfile.ZIP_DEFLATED)
                fill = np.zeros(np.asarray(instance).shape, np.uint8)
                for k in range(i):
                    self._put_mask(k, fill)
            if instance is None:
                instance = np.zeros(self._mask_shape, np.uint8)
            self._mask_shape = np.asarray(instance).shape
            self._put_mask(i, instance)
            self.wrote_mask = True
        self.n_frames += 1

    def close(self, phrases: Optional[List[str]] = None):
        if self._rgb_writer is not None:
            self._rgb_writer.release()
        if self._depth_zip is not None:
            self._depth_zip.close()
        if self._mask_zip is not None:
            self._mask_zip.close()
            if phrases is not None:
                if isinstance(phrases, dict):
                    text = "\n".join(f"{int(k)}: {v}" for k, v in sorted(phrases.items()))
                else:
                    text = "\n".join(phrases)
                self.path.mask_phrase_path.write_text(text)


# ------------------------------------------------------------------ readers


def read_pose_artifacts(path: ArtifactPath):
    """Returns (mats (T, 4, 4), inds (T,))."""
    z = np.load(path.pose_path)
    return z["data"], z.get("inds", np.arange(len(z["data"])))


def read_intrinsics_artifacts(path: ArtifactPath):
    z = np.load(path.intrinsics_path)
    camera_type = (path.camera_type_path.read_text().strip()
                   if path.camera_type_path.exists() else "pinhole")
    return z["data"], camera_type


def read_depth_zip(zip_path) -> Iterator[np.ndarray]:
    from .exr import decode_exr

    with zipfile.ZipFile(zip_path) as zf:
        for name in sorted(zf.namelist()):
            data = zf.read(name)
            if name.endswith(".npy"):
                yield np.load(_io.BytesIO(data)).astype(np.float32)
            elif name.endswith(".exr"):
                yield decode_exr(data)


def read_info(path: ArtifactPath) -> dict:
    with open(path.info_path, "rb") as f:
        return pickle.load(f)
