"""Stream processors of the annotation pipeline (port of
``vipe_tpu/pipeline/processors.py``: the FOV heuristic and GeoCalib)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..streams.base import FrameAttribute, StreamProcessor, VideoFrame
from ..utils import profiling


class HeuristicIntrinsicsProcessor(StreamProcessor):
    """FOV-heuristic intrinsics: fx = fy from an assumed horizontal FOV,
    principal point at the centre."""

    def __init__(self, fov_deg: float = 60.0):
        self.fov_deg = fov_deg

    def __call__(self, frame_idx: int, frame: VideoFrame) -> VideoFrame:
        if frame.intrinsics is None:
            h, w = frame.size()
            f = 0.5 * w / np.tan(np.deg2rad(self.fov_deg) / 2.0)
            frame.intrinsics = np.asarray([f, f, w / 2.0, h / 2.0], np.float32)
        return frame

    def update_attributes(self, previous):
        return set(previous) | {FrameAttribute.INTRINSICS}


class GeoCalibIntrinsicsProcessor(StreamProcessor):
    """Learned single-image calibration, run once at construction: a pinhole
    camera is calibrated from frames 0, gap and 2·gap (``gap_sec`` apart,
    at most half the video) with one shared focal, a distorted one (MEI)
    from frame 0 alone.  The result is stamped on every frame."""

    def __init__(self, camera_type: str = "pinhole", sample_stream=None,
                 gap_sec: float = 1.0, device=None):
        from ..models.model_cache import cached_global
        from ..priors.geocalib import GeoCalib
        from ..utils.device import resolve_device

        # SLAM camera type → GeoCalib model
        model = {"pinhole": "pinhole", "mei": "simple_mei"}.get(camera_type, camera_type)
        device = resolve_device(device)
        self.model = cached_global(("geocalib", GeoCalib, model, str(device)),
                                   lambda: GeoCalib(model, device=device))
        self.camera_type = camera_type
        self.gap_sec = gap_sec
        self._intr = None
        if sample_stream is not None:
            self.calibrate_from_stream(sample_stream)

    def sample_indices(self, n: int, fps: float) -> List[int]:
        gap = min(int(self.gap_sec * (fps or 30.0)), max((n - 1) // 2, 0))
        return [0] if self.camera_type != "pinhole" else [0, gap, 2 * gap]

    def calibrate_from_stream(self, stream):
        want = set(self.sample_indices(len(stream), stream.fps()))
        frames = []
        for k, f in enumerate(stream):
            if k in want:
                frames.append(f.rgb)
            if k >= max(want):
                break
        self.calibrate(frames)

    def calibrate(self, frames: List[np.ndarray]):
        with profiling.stage("geocalib"):
            self._intr = self.model.calibrate(frames)

    def update_attributes(self, previous):
        return set(previous) | {FrameAttribute.INTRINSICS}

    def __call__(self, frame_idx: int, frame: VideoFrame) -> VideoFrame:
        if self._intr is not None:
            frame.intrinsics = np.asarray(self._intr, np.float32)
        return frame
