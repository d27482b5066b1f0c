"""Raw mp4 decoding via OpenCV (port of ``vipe_tpu/streams/raw_mp4_stream.py``).
OpenCV is imported only when a file is opened."""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np

from .base import FrameAttribute, MultiviewVideoList, StreamList, VideoFrame, VideoStream


class RawMp4Stream(VideoStream):
    """Single mp4 file → RGB float frames, with an optional seek range."""

    def __init__(self, path, seek_range: Optional[tuple] = None):
        import cv2

        self.path = str(path)
        self._name = pathlib.Path(path).stem
        cap = cv2.VideoCapture(self.path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self._fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        self._w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self._h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        start, end, step = 0, n, 1
        if seek_range is not None:
            start, end, step = seek_range
            end = min(end if end is not None and end > 0 else n, n)
        self.start, self.end, self.step = start, end, step

    def __len__(self):
        return max(0, (self.end - self.start + self.step - 1) // self.step)

    def fps(self):
        return self._fps / self.step

    def frame_size(self):
        return (self._h, self._w)

    def attributes(self):
        return {FrameAttribute.RGB}

    def __iter__(self):
        import cv2

        cap = cv2.VideoCapture(self.path)
        if self.start:
            cap.set(cv2.CAP_PROP_POS_FRAMES, self.start)
        raw = self.start
        while raw < self.end:
            ok, frame = cap.read()
            if not ok:
                break
            if (raw - self.start) % self.step == 0:
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                yield VideoFrame(raw_frame_idx=raw, rgb=rgb.astype(np.float32) / 255.0)
            raw += 1
        cap.release()


class RawMp4StreamList(StreamList):
    """File path or directory of mp4s."""

    def __init__(self, base_path, seek_range=None, **_):
        p = pathlib.Path(base_path)
        files = sorted(p.glob("*.mp4")) if p.is_dir() else [p]
        super().__init__([RawMp4Stream(f, seek_range) for f in files])


class MultiviewMp4StreamList(StreamList):
    """One rig capture from per-view mp4s, as a list holding one
    ``MultiviewVideoList``.  ``videos``: the views' files; ``rig``: a
    (V, 7) camera-to-rig array as a ``.npy`` path or inline, identity for
    every view when absent; ``name``: the capture's name (the first
    video's stem when absent)."""

    def __init__(self, videos, rig=None, name=None, seek_range=None, **_):
        streams = [RawMp4Stream(pathlib.Path(v), seek_range) for v in videos]
        if rig is None:
            r = np.zeros((len(streams), 7), np.float32)
            r[:, 6] = 1.0
        elif isinstance(rig, (str, pathlib.Path)):
            r = np.load(rig).astype(np.float32)
        else:
            r = np.asarray(rig, np.float32)
        name = name or pathlib.Path(videos[0]).stem
        super().__init__([MultiviewVideoList(name, streams, r)])
