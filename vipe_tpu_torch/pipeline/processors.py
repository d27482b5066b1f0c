"""Stream processors of the annotation pipeline (port of
``vipe_tpu/pipeline/processors.py``: the FOV heuristic)."""

from __future__ import annotations

import numpy as np

from ..streams.base import FrameAttribute, StreamProcessor, VideoFrame


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
