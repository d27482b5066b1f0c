"""SLAMSystem: the two-pass driver (port of ``vipe_tpu/slam/system.py``,
single view).

Pass 1: motion filter on every frame → keyframe buffer → frontend tracking
with backend runs at the ``frontend_backend_iters`` milestones.  Then the
global backend, twice.  Pass 2: every frame again; non-keyframe poses are
interpolated per ``infill_chunk_size`` chunk by the inner filler.  Returns
the camera-to-world trajectory, the refined intrinsics and the filtered
keyframe map.

Besides the pinhole stream with no priors, a run takes MEI and panorama
cameras, per-frame validity masks, streams that give poses (the frontend
then keeps them fixed), a keyframe depth prior (``metric_depth``, built by
the pipeline from ``slam.keyframe_depth``) and a fixed keyframe stride.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cameras as cam
from ..ops import lie
from ..streams.base import FrameAttribute, ProcessedVideoStream, StreamProcessor, VideoFrame
from ..utils import profiling
from ..utils.device import resolve_device
from .backend import SLAMBackend
from .buffer import GraphBuffer
from .frontend import SLAMFrontend
from .inner_filler import InnerFiller
from .interface import SLAMOutput
from .motion_filter import MotionFilter

ENC_BATCH = 8  # pass-2 frames per feature-encoder call

# config values this port does not implement yet (key → allowed value)
_UNSUPPORTED = {
    "visualize": False,
    "sparse_tracks": None,
    "infill_dense_disp": False,
}


def check_supported(config: dict):
    """Raise ``NotImplementedError`` for any value the port does not run."""
    for key, ok in _UNSUPPORTED.items():
        val = config.get(key, ok)
        if val != ok and not (ok is None and not val):
            raise NotImplementedError(f"slam.{key}={val!r} is not ported yet")


def mask_grid(mask: np.ndarray, ht: int, wd: int) -> torch.Tensor:
    """Full-res validity mask (True = valid) → the (ht, wd) invalid mask of
    the SLAM grid: bilinear downscale with half-pixel centres and no
    antialiasing (what OpenCV's ``INTER_LINEAR`` computes), keep the cells
    whose valid fraction is above 0.9, invert."""
    m = torch.as_tensor(np.asarray(mask, np.float32))[None, None]
    small = F.interpolate(m, size=(ht, wd), mode="bilinear", align_corners=False,
                          antialias=False)[0, 0]
    return ~(small > 0.9)


class StandardResizeStreamProcessor(StreamProcessor):
    """Resize every input to ≈ ``target_area`` px, crop to /8 multiples;
    remembers the factors so intrinsics map back to the input resolution."""

    def __init__(self, target_area: int = 384 * 512):
        self.target_area = target_area
        self.fac_x = self.fac_y = 1.0
        self.scx = self.scy = 0

    def _compute(self, prev):
        h0, w0 = prev
        scale = float(np.sqrt(self.target_area / (h0 * w0)))
        h1, w1 = int(h0 * scale), int(w0 * scale)
        ch, cw = h1 % 8, w1 % 8
        top, bottom = ch // 2, ch - ch // 2
        left, right = cw // 2, cw - cw // 2
        self.fac_x, self.fac_y = w0 / w1, h0 / h1
        self.scx, self.scy = left, top
        return (h1, w1), (top, bottom, left, right)

    def update_frame_size(self, previous):
        (h1, w1), (t, b, l, r) = self._compute(previous)
        return h1 - t - b, w1 - l - r

    def __call__(self, frame_idx: int, frame: VideoFrame) -> VideoFrame:
        (h1, w1), (t, b, l, r) = self._compute(frame.size())
        return frame.resize((h1, w1)).crop(t, b, l, r)

    def recover_intrinsics(self, intr: np.ndarray) -> np.ndarray:
        out = np.asarray(intr).copy()
        out[2] += self.scx
        out[3] += self.scy
        out[0:4:2] *= self.fac_x
        out[1:4:2] *= self.fac_y
        return out


def droidnet_fns(model):
    """(encode_features, encode_context, update_fn) over a DroidNet, with
    ``update_fn`` in the FactorGraph injection protocol."""

    def update_fn(net, inp, corr, motn, ii, jj, num_frames):
        return model.update(net, inp, corr, motn, ii, num_frames)

    return model.encode_features, model.encode_context, update_fn


class SLAMSystem:
    """Single-video SLAM driver.  ``config`` is a plain dict (the
    ``pipeline.slam`` section); ``metric_depth`` an optional keyframe depth
    prior.  Without an injected ``update_fn`` it builds DroidNet (bf16) on
    ``device``."""

    def __init__(self, config: Optional[dict] = None, device=None,
                 update_fn: Optional[Callable] = None,
                 encode_features: Optional[Callable] = None,
                 encode_context: Optional[Callable] = None,
                 metric_depth=None):
        self.config = dict(config or {})
        check_supported(self.config)
        self.device = resolve_device(device)
        if update_fn is None:
            from ..models.droidnet import build_droidnet

            self.model = build_droidnet(self.device)
            encode_features, encode_context, update_fn = droidnet_fns(self.model)
        self.update_fn = update_fn
        self.encode_features = encode_features
        self.encode_context = encode_context
        self.metric_depth = metric_depth

    def _upload(self, frame: VideoFrame) -> torch.Tensor:
        rgb = (np.clip(frame.rgb, 0.0, 1.0) * 255).astype(np.uint8)
        return torch.from_numpy(rgb).to(self.device)

    def _mask(self, frame: VideoFrame, buffer: GraphBuffer) -> Optional[torch.Tensor]:
        if frame.mask is None:
            return None
        return mask_grid(frame.mask, buffer.ht, buffer.wd).to(self.device)

    @staticmethod
    def _base_pose(frame: VideoFrame) -> Optional[np.ndarray]:
        """The world-to-camera pose of a frame that gives its pose."""
        if frame.pose is None:
            return None
        return lie.se3_inv(torch.tensor(np.asarray(frame.pose), dtype=torch.float32)).numpy()

    @torch.no_grad()
    def run(self, video_stream, camera_type: cam.CameraType = cam.CameraType.PINHOLE
            ) -> SLAMOutput:
        c = self.config
        resizer = StandardResizeStreamProcessor(c.get("resize_area", 384 * 512))
        stream = ProcessedVideoStream(video_stream, [resizer])
        c = {**c, "has_init_pose": FrameAttribute.POSE in stream.attributes()}
        h, w = stream.frame_size()
        total = len(stream)

        buffer = GraphBuffer(
            height=h, width=w, buffer_size=c.get("buffer", 1024),
            init_disp=c.get("init_disp", 1.0), camera_type=camera_type,
            dense_disp_alpha=c.get("ba", {}).get("dense_disp_alpha", 0.001),
            device=self.device,
        )
        motion_filter = MotionFilter(self.encode_features, self.encode_context,
                                     self.update_fn, thresh=c.get("filter_thresh", 2.4))
        frontend = SLAMFrontend(buffer, self.update_fn, c)
        backend = SLAMBackend(buffer, self.update_fn, c, depth_model=self.metric_depth)
        filler = InnerFiller(buffer, self.update_fn, c)
        fbi = c.get("frontend_backend_iters", [16, 64, 256])
        kf_stride = c.get("keyframe_stride")

        # ----------------------------------------------------------- pass 1
        with profiling.stage("slam_pass1"):
            for frame_idx, frame in enumerate(stream):
                rgb = self._upload(frame)
                mask = self._mask(frame, buffer)
                token = motion_filter.submit(rgb, mask)
                is_kf = motion_filter.resolve(token)
                if is_kf:
                    fmap, net, inp = motion_filter.last_keyframe_features
                elif frame_idx == total - 1 or (kf_stride and frame_idx % kf_stride == 0):
                    # the last frame and every stride-th one are keyframes
                    is_kf = True
                    fmap = token.fmap[0]
                    net, inp = (x[0] for x in self.encode_context(rgb[None]))
                if is_kf:
                    # apply the removal decisions still pending, keeping the
                    # newest one pending at depth 2
                    frontend.resolve_pending(keep_newest=True)
                    buffer.append_keyframe(
                        frame_idx, rgb, fmap, net, inp, mask=mask,
                        metric_depth=frame.metric_depth, intrinsics=frame.intrinsics,
                        pose=self._base_pose(frame),
                    )
                    if self.metric_depth is not None and frame.metric_depth is None:
                        buffer.update_disps_sens(self.metric_depth,
                                                 frame_idx=buffer.n_frames - 1)
                frontend.run()
                if is_kf and any(buffer.n_frames - k in fbi for k in range(3)):
                    # pending removals may hold n_frames up to two high
                    frontend.resolve_pending()
                    if buffer.n_frames in fbi:
                        backend.run_if_necessary(5)
                        # the backend moved poses and disparities
                        frontend.drop_cached_distance()
            frontend.resolve_pending()
        keyframes = buffer.tstamp[: buffer.n_frames].copy()

        # -------------------------------------------------------- global BA
        with profiling.stage("slam_backend"):
            backend.run(7)
            backend.run(c.get("backend_iters", 24), update_depth=False)

        # ----------------------------------------------------------- pass 2
        with profiling.stage("slam_pass2"):
            filler.set_start_idx(buffer.n_frames)
            kf_slot = {int(t): i for i, t in enumerate(keyframes)}
            batch = []

            def flush():
                new = [b for b in batch if b[0] not in kf_slot]
                fmaps = None
                if new:
                    fmaps = self.encode_features(torch.stack([b[2] for b in new]))
                k = 0
                for frame_idx, frame, rgb in batch:
                    if frame_idx in kf_slot:
                        buffer.append_keyframe_copy(kf_slot[frame_idx], frame_idx)
                    else:
                        buffer.append_keyframe(frame_idx, rgb, fmaps[k], None, None,
                                               mask=self._mask(frame, buffer),
                                               metric_depth=frame.metric_depth)
                        k += 1
                    if filler.check() or frame_idx == total - 1:
                        filler.compute()
                batch.clear()

            for frame_idx, frame in enumerate(stream):
                rgb = None if frame_idx in kf_slot else self._upload(frame)
                batch.append((frame_idx, frame, rgb))
                if len(batch) == ENC_BATCH:
                    flush()
            flush()
        filled = filler.get_result()
        if filled.poses.shape[0] != total:
            raise ValueError("video exhausted early — possibly malformed")

        slam_map = buffer.extract_slam_map(c.get("map_filter_thresh", 0.05))
        if camera_type == cam.CameraType.PANORAMA:
            # panorama artifacts carry all-zero intrinsics; the pixel-unit
            # equirect scales are the SLAM grid's own parameterisation
            intr_full = np.zeros(buffer.intrinsics.shape, np.float32)
        else:
            intr_full = resizer.recover_intrinsics(buffer.intrinsics.cpu().numpy())
        trajectory = lie.se3_inv(torch.as_tensor(filled.poses)).numpy()
        return SLAMOutput(
            trajectory=trajectory, intrinsics=intr_full, camera_type=camera_type,
            slam_map=slam_map, ba_residual=backend.last_residual, keyframes=keyframes,
            frontend_stats={"n_removals": frontend.n_removals,
                            "late_removals": frontend.late_removals,
                            "host_waits": frontend.graph.host_waits},
        )
