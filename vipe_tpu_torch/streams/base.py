"""Lazy video stream layer (port of ``vipe_tpu/streams/base.py``).

Frames are numpy HWC float32 RGB in [0, 1] on the host; device placement
happens at the consumer.  ``VideoFrame.resize`` uses
``torch.nn.functional.interpolate`` (bilinear, half-pixel centres, no
antialias — OpenCV's ``INTER_LINEAR``; nearest for label maps), so the
stream layer needs no OpenCV.
"""

from __future__ import annotations

import dataclasses
import importlib
from enum import Enum
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


class FrameAttribute(Enum):
    RGB = "rgb"
    MASK = "mask"
    INSTANCE = "instance"
    METRIC_DEPTH = "metric_depth"
    POSE = "pose"
    INTRINSICS = "intrinsics"


def _resize(x: np.ndarray, size: tuple, mode: str) -> np.ndarray:
    """(H, W[, C]) numpy array → (h, w[, C]) with ``interpolate``."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    chw = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    kw = {"align_corners": False} if mode == "bilinear" else {}
    out = F.interpolate(chw.float(), size=size, mode=mode, **kw)[0]
    out = out[0] if t.dim() == 2 else out.permute(1, 2, 0)
    return out.numpy().astype(x.dtype, copy=False)


@dataclasses.dataclass
class VideoFrame:
    """Per-frame record.

    rgb: (H, W, 3) float32 in [0, 1]; mask: (H, W) bool, True = valid;
    instance: (H, W) int ids; metric_depth: (H, W) float32; pose: (7,)
    cam-to-world ``[t, q]``; intrinsics: (D,) full-res.
    """

    raw_frame_idx: int
    rgb: np.ndarray
    mask: Optional[np.ndarray] = None
    instance: Optional[np.ndarray] = None
    instance_phrases: Optional[dict] = None
    metric_depth: Optional[np.ndarray] = None
    pose: Optional[np.ndarray] = None
    intrinsics: Optional[np.ndarray] = None

    SKY_PROMPT = "sky"

    def size(self) -> tuple:
        return self.rgb.shape[0], self.rgb.shape[1]

    @property
    def sky_mask(self) -> np.ndarray:
        """(H, W) bool, True where an instance labelled ``sky`` lies: valid
        for SLAM's weights, left out of depth alignment."""
        out = np.zeros(self.size(), bool)
        if self.instance is not None and self.instance_phrases:
            sky_ids = [i for i, p in self.instance_phrases.items() if p == self.SKY_PROMPT]
            if sky_ids:
                lut = np.zeros(int(max(self.instance.max(), max(sky_ids))) + 1, bool)
                lut[sky_ids] = True
                out = lut[self.instance]
        return out

    def resize(self, new_size: tuple) -> "VideoFrame":
        h1, w1 = new_size
        h0, w0 = self.size()
        if (h0, w0) == (h1, w1):
            return self
        rgb = np.asarray(self.rgb)
        out = dataclasses.replace(self, rgb=_resize(rgb.astype(np.float32), (h1, w1), "bilinear"))
        if self.mask is not None:
            out.mask = _resize(self.mask.astype(np.uint8), (h1, w1), "nearest").astype(bool)
        if self.instance is not None:
            out.instance = _resize(self.instance, (h1, w1), "nearest")
        if self.metric_depth is not None:
            out.metric_depth = _resize(self.metric_depth, (h1, w1), "nearest")
        if self.intrinsics is not None:
            intr = self.intrinsics.copy()
            intr[0:4:2] *= w1 / w0
            intr[1:4:2] *= h1 / h0
            out.intrinsics = intr
        return out

    def crop(self, top: int, bottom: int, left: int, right: int) -> "VideoFrame":
        h, w = self.size()
        sl = (slice(top, h - bottom), slice(left, w - right))
        out = dataclasses.replace(self, rgb=self.rgb[sl])
        for name in ("mask", "instance", "metric_depth"):
            v = getattr(self, name)
            if v is not None:
                setattr(out, name, v[sl])
        if self.intrinsics is not None:
            intr = self.intrinsics.copy()
            intr[2] -= left
            intr[3] -= top
            out.intrinsics = intr
        return out


class VideoStream:
    """Sized, re-iterable stream of VideoFrames."""

    def __iter__(self) -> Iterator[VideoFrame]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def frame_size(self) -> tuple:
        raise NotImplementedError

    def fps(self) -> float:
        return 30.0

    def attributes(self) -> set:
        return {FrameAttribute.RGB}

    def name(self) -> str:
        return getattr(self, "_name", "stream")

    def cache(self, online: bool = False, compress_rgb: bool = False) -> "CachedVideoStream":
        return CachedVideoStream(self, online=online, compress_rgb=compress_rgb)


class StreamProcessor:
    """Per-frame transform protocol."""

    def __call__(self, frame_idx: int, frame: VideoFrame) -> VideoFrame:
        raise NotImplementedError

    def update_frame_size(self, previous: tuple) -> tuple:
        return previous

    def update_attributes(self, previous: set) -> set:
        return previous

    def update_iterator(self, it: Iterator[VideoFrame]) -> Iterator[VideoFrame]:
        for idx, frame in enumerate(it):
            yield self(idx, frame)


class ProcessedVideoStream(VideoStream):
    """Composed lazy stream."""

    def __init__(self, stream: VideoStream, processors: Sequence[StreamProcessor]):
        self.stream = stream
        self.processors = list(processors)
        self._name = stream.name()

    def __len__(self):
        return len(self.stream)

    def fps(self):
        return self.stream.fps()

    def frame_size(self):
        size = self.stream.frame_size()
        for p in self.processors:
            size = p.update_frame_size(size)
        return size

    def attributes(self):
        attrs = self.stream.attributes()
        for p in self.processors:
            attrs = p.update_attributes(attrs)
        return attrs

    def __iter__(self):
        it = iter(self.stream)
        for p in self.processors:
            it = p.update_iterator(it)
        return it


class CachedVideoStream(VideoStream):
    """Decode-once memory cache: eager on construction, or (``online``)
    filled as consumed.  ``compress_rgb`` stores rgb as uint8 (an exact
    round trip for video-decoded k/255 values)."""

    def __init__(self, stream: VideoStream, online: bool = False,
                 compress_rgb: bool = False):
        self.stream = stream
        self._name = stream.name()
        self._compress = compress_rgb
        self._frames: List[Optional[VideoFrame]] = [None] * len(stream)
        self._filled = 0
        if not online:
            self._fill_all()

    def _fill_all(self):
        n = 0
        for i, f in enumerate(self.stream):
            if i >= len(self._frames):
                break
            self._frames[i] = self._pack(f)
            n = i + 1
        self._frames = self._frames[:n]  # early source exhaustion truncates
        self._filled = n

    def _pack(self, frame: VideoFrame) -> VideoFrame:
        if not self._compress or frame.rgb.dtype == np.uint8:
            return frame
        rgb8 = np.rint(np.clip(frame.rgb, 0.0, 1.0) * 255.0).astype(np.uint8)
        return dataclasses.replace(frame, rgb=rgb8)

    def _unpack(self, frame: VideoFrame) -> VideoFrame:
        if not self._compress or frame.rgb.dtype != np.uint8:
            return frame
        return dataclasses.replace(frame, rgb=frame.rgb.astype(np.float32) / 255.0)

    def __len__(self):
        return len(self._frames)

    def fps(self):
        return self.stream.fps()

    def frame_size(self):
        return self.stream.frame_size()

    def attributes(self):
        return self.stream.attributes()

    def __iter__(self):
        if self._filled < len(self._frames):
            self._fill_all()
        for f in self._frames:
            yield self._unpack(f)


class AssignAttributesProcessor(StreamProcessor):
    """Write precomputed per-frame attributes into the stream."""

    def __init__(self, poses=None, intrinsics=None, metric_depths=None):
        self.poses = poses
        self.intrinsics = intrinsics
        self.metric_depths = metric_depths

    def update_attributes(self, previous):
        attrs = set(previous)
        if self.poses is not None:
            attrs.add(FrameAttribute.POSE)
        if self.intrinsics is not None:
            attrs.add(FrameAttribute.INTRINSICS)
        if self.metric_depths is not None:
            attrs.add(FrameAttribute.METRIC_DEPTH)
        return attrs

    def __call__(self, frame_idx: int, frame: VideoFrame) -> VideoFrame:
        if self.poses is not None:
            frame.pose = np.asarray(self.poses[frame_idx])
        if self.intrinsics is not None:
            intr = self.intrinsics
            frame.intrinsics = np.asarray(intr[frame_idx] if np.ndim(intr) > 1 else intr)
        if self.metric_depths is not None:
            frame.metric_depth = np.asarray(self.metric_depths[frame_idx])
        return frame


class MultiviewVideoList:
    """The synchronised per-view streams of one rig capture.  ``rig``:
    (V, 7) camera-to-rig SE3 (xyz + quaternion) per view; view v's camera
    pose is the frame's rig pose composed with ``rig[v]``."""

    def __init__(self, name: str, video_streams: Sequence[VideoStream], rig):
        rig = np.asarray(rig, np.float32)
        if rig.ndim == 1:
            rig = rig[None]
        if rig.shape != (len(video_streams), 7):
            raise ValueError(f"rig must be ({len(video_streams)}, 7), got {rig.shape}")
        self._name = name
        self._streams = list(video_streams)
        self.rig = rig
        self._len = len(self._streams[0])
        if any(len(vs) != self._len for vs in self._streams):
            raise ValueError("the views of a rig need equal lengths")

    def __len__(self):
        return len(self._streams)

    def __iter__(self):
        return iter(self._streams)

    def __getitem__(self, idx: int) -> VideoStream:
        return self._streams[idx]

    def name(self) -> str:
        return self._name

    def num_frames(self) -> int:
        return self._len

    def cache(self, *args, **kwargs) -> "MultiviewVideoList":
        """Itself: the rig pipeline caches each view on its own."""
        return self


class StreamList:
    """Multi-video collection, and the factory of the ``streams`` config."""

    def __init__(self, streams: Sequence[VideoStream]):
        self.streams = list(streams)

    def __len__(self):
        return len(self.streams)

    def __iter__(self):
        return iter(self.streams)

    @staticmethod
    def make(config: dict) -> "StreamList":
        """The class named by the dotted ``instance`` (a
        ``vipe_tpu_torch.streams...`` path), built with the other keys."""
        module, cls = config["instance"].rsplit(".", 1)
        klass = getattr(importlib.import_module(module), cls)
        return klass(**{k: v for k, v in config.items() if k != "instance"})
