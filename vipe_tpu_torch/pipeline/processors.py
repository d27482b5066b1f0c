"""Stream processors of the annotation pipeline (port of
``vipe_tpu/pipeline/processors.py``: the FOV heuristic, GeoCalib,
TrackAnything's instance masks and the post-SLAM adaptive depth)."""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..priors.depth.alignment import align_inv_depth_to_depth, apply_inv_depth_alignment
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


class TrackAnythingProcessor(StreamProcessor):
    """Open-vocabulary instance masks: each frame gets ``instance`` (ids, 0
    the static scene), ``instance_phrases`` ({id: phrase}) and ``mask``,
    the pixels SLAM may use: neither an instance nor next to one (eroded by
    ``mask_expand``), sky counting as valid.  The engine is stateful (SAM's
    embedding, DeAOT's memory, the id counters): one per thread and device
    is cached for the process and reset for each video."""

    def __init__(self, phrases: List[str], mask_expand: int = 5, device=None, **kwargs):
        from ..models.model_cache import cached_thread
        from ..priors.track_anything import TrackAnythingPipeline
        from ..utils.device import resolve_device

        device = resolve_device(device)
        key = ("track_anything", TrackAnythingPipeline, tuple(phrases),
               tuple(sorted(kwargs.items())), str(device))
        self.pipeline = cached_thread(
            key, lambda: TrackAnythingPipeline(phrases, device=device, **kwargs))
        self.pipeline.reset()
        self.mask_expand = mask_expand

    def update_attributes(self, previous):
        return set(previous) | {FrameAttribute.INSTANCE, FrameAttribute.MASK}

    def __call__(self, frame_idx: int, frame: VideoFrame) -> VideoFrame:
        from ..ops.morph import erode

        with profiling.stage("track_anything"):
            instance, phrases_map = self.pipeline.track(frame_idx, frame.rgb)
            frame.instance = instance
            frame.instance_phrases = phrases_map
            with profiling.stage("ta_host_mask"):
                frame.mask = np.asarray(erode((instance == 0) | frame.sky_mask,
                                              self.mask_expand))
        return frame


def _host(depth) -> np.ndarray:
    return depth.detach().cpu().numpy() if torch.is_tensor(depth) else np.asarray(depth)


class AdaptiveDepthProcessor(StreamProcessor):
    """Post-SLAM metric depth, ``adaptive_<metric>_<svda|vda>`` (the VDA
    part optional):

    * on frame 0, the SLAM map's UV coverage over every 10th pose decides
      the branch: below ``coverage_thresh`` the metric model
      (``<metric>``, in chunks of ``POST_BATCH`` frames), else PriorDA
      prompted by the map projected into each frame, with the metric
      model for a frame whose completed depth is not finite;
    * with VDA (svda: ViT-S, vda: ViT-L), the whole video's temporally
      stable disparity is fitted to each frame's depth (affine in inverse
      depth, dynamic and sky pixels left out, the fit smoothed by a 0.99
      EMA) and replaces it.

    The models are built on ``device`` and cached per process.  PriorDA
    runs its fine stage when the zoo holds ``priorda_fine`` weights."""

    # frames per stacked metric-model forward
    POST_BATCH = 8

    def __init__(self, model: str, slam_output=None, coverage_thresh: float = 0.3,
                 device=None):
        from ..models.model_cache import cached_global
        from ..priors.depth.factory import make_depth_model
        from ..utils.device import resolve_device

        parts = model.split("_")
        if parts[0] != "adaptive" or len(parts) < 2:
            raise ValueError(f"expected adaptive_<metric>[_<svda|vda>]: {model}")
        self.coverage_thresh = coverage_thresh
        self.slam_output = slam_output
        self.device = resolve_device(device)
        self.metric_model = make_depth_model(parts[1], device=self.device)
        self.priorda = None  # built when the coverage asks for it
        self.vda = None
        vda_kind = parts[2] if len(parts) > 2 else None
        if vda_kind in ("vda", "svda"):
            from ..priors.depth.videodepthanything import VideoDepthAnythingModel

            variant = "vitl" if vda_kind == "vda" else "vits"
            self.vda = cached_global(
                ("vda", VideoDepthAnythingModel, variant, str(self.device)),
                lambda: VideoDepthAnythingModel(variant, device=self.device))
        elif vda_kind is not None:
            raise ValueError(f"unknown VDA kind {vda_kind!r} in {model}")
        self.use_metric: Optional[bool] = None
        self.coverage: Optional[float] = None
        self._ema_scale: Optional[float] = None
        self._ema_bias: Optional[float] = None

    def _w2c(self) -> np.ndarray:
        from ..ops import lie

        return lie.se3_inv(torch.as_tensor(np.asarray(self.slam_output.trajectory, np.float32))
                           ).numpy()

    def coverage_score(self, image_size, intrinsics) -> float:
        """The least UV coverage of the map over every 10th pose, at the
        frame's size and intrinsics (0 without a map)."""
        out = self.slam_output
        if out is None or out.slam_map is None:
            return 0.0
        w2c = self._w2c()
        scores = [out.slam_map.uv_coverage_score(
            w2c[k], np.asarray(intrinsics, np.float32), out.camera_type,
            image_size=tuple(image_size), frame_idx=k) for k in range(0, len(w2c), 10)]
        return float(min(scores)) if scores else 0.0

    def _decide(self, frame) -> bool:
        from ..models import zoo
        from ..models.model_cache import cached_global
        from ..priors.depth.priorda import PriorDAModel

        self.coverage = self.coverage_score(frame.size(), frame.intrinsics)
        use_metric = self.coverage < self.coverage_thresh
        if not use_metric and self.priorda is None:
            # random fine weights would replace the prompt-aligned coarse
            # depth with noise: the fine stage runs only with its weights
            coarse_only = not zoo.has_weights("priorda_fine")
            self.priorda = cached_global(
                ("priorda", PriorDAModel, coarse_only, str(self.device)),
                lambda: PriorDAModel(coarse_only=coarse_only, device=self.device))
        return use_metric

    def _project_prompt(self, frame, frame_idx, w2c):
        out = self.slam_output
        return out.slam_map.project_map(w2c[frame_idx], out.intrinsics, out.camera_type,
                                        frame.size(), frame_idx=frame_idx)

    @staticmethod
    def _focal(frame):
        return float(frame.intrinsics[0]) if frame.intrinsics is not None else None

    def _metric(self, frames):
        """One batched forward when every frame has the first one's shape and
        focal, else frame by frame."""
        focal0 = self._focal(frames[0])
        same = all(f.rgb.shape == frames[0].rgb.shape and self._focal(f) == focal0
                   for f in frames)
        with profiling.stage("post_metric_depth"):
            if same:
                depths = self.metric_model.estimate_depth_batch([f.rgb for f in frames], focal0)
            else:
                depths = [d for f in frames
                          for d in self.metric_model.estimate_depth_batch([f.rgb], self._focal(f))]
        return [_host(d) for d in depths]

    def _chunk_depths(self, chunk, first_idx, w2c):
        if self.use_metric:
            return self._metric(chunk)
        prompts = [self._project_prompt(f, first_idx + j, w2c) for j, f in enumerate(chunk)]
        with profiling.stage("priorda"):
            depths = self.priorda.complete_batch([f.rgb for f in chunk], prompts)
        return [d if np.isfinite(d).all() else self._metric([f])[0]
                for f, d in zip(chunk, map(_host, depths))]

    def _finish_frame(self, frame, frame_idx, depth, vda_disps):
        if vda_disps is not None:
            disp = vda_disps[frame_idx]
            align_mask = disp > 1e-3
            if frame.mask is not None:
                # dynamic and sky pixels stay out of the fit
                align_mask &= np.asarray(frame.mask) & ~frame.sky_mask
            s_, b_ = align_inv_depth_to_depth(disp, depth, align_mask)
            if self._ema_scale is None:
                self._ema_scale, self._ema_bias = s_, b_
            else:
                self._ema_scale = 0.99 * self._ema_scale + 0.01 * s_
                self._ema_bias = 0.99 * self._ema_bias + 0.01 * b_
            depth = apply_inv_depth_alignment(disp, self._ema_scale, self._ema_bias)
        frame.metric_depth = np.asarray(depth, np.float32)
        return frame

    def update_iterator(self, it: Iterator[VideoFrame]) -> Iterator[VideoFrame]:
        vda_disps = None
        if self.vda is not None:
            frames = list(it)
            with profiling.stage("vda"):
                vda_disps = self.vda.infer_video_depth([f.rgb for f in frames])
            it = iter(frames)
        w2c = None
        frame_idx = 0
        chunk: List[VideoFrame] = []
        for frame in itertools.chain(it, [None]):
            if frame is not None:
                chunk.append(frame)
                if len(chunk) < self.POST_BATCH:
                    continue
            if not chunk:
                break
            if frame_idx == 0:
                self.use_metric = self._decide(chunk[0])
                if not self.use_metric:
                    w2c = self._w2c()
            for j, depth in enumerate(self._chunk_depths(chunk, frame_idx, w2c)):
                yield self._finish_frame(chunk[j], frame_idx + j, depth, vda_disps)
            frame_idx += len(chunk)
            chunk = []

    def update_attributes(self, previous):
        return set(previous) | {FrameAttribute.METRIC_DEPTH}
