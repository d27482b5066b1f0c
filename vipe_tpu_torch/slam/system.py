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
the pipeline from ``slam.keyframe_depth``), a fixed keyframe stride,
sparse keypoint tracks (``slam.sparse_tracks``: every frame tracked in pass
1, their flow in the motion filter and the BA), the chunks' disparities
solved in pass 2 (``slam.infill_dense_disp``) and live telemetry
snapshots (``slam.visualize``, every ``visualize_every`` keyframes under
``visualize_path``).

A rig (a ``MultiviewVideoList``) runs V synchronised views of equal size
and length as one system: each frame is the stack of its V views, the
trajectory is the rig base's, and the output carries the (refined) rig and
(V, D) intrinsics.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cameras as cam
from ..ops import lie
from ..streams.base import (FrameAttribute, MultiviewVideoList, ProcessedVideoStream,
                            StreamProcessor, VideoFrame)
from ..utils import profiling
from ..utils.device import resolve_device
from .backend import SLAMBackend
from .buffer import GraphBuffer
from .frontend import SLAMFrontend
from .inner_filler import InnerFiller
from .interface import SLAMOutput
from .motion_filter import MotionFilter
from .sparse_tracks import build_sparse_tracks

ENC_BATCH = 8  # pass-2 frames per feature-encoder call


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
        self.device = resolve_device(device)
        if update_fn is None:
            from ..models.droidnet import build_droidnet

            self.model = build_droidnet(self.device)
            encode_features, encode_context, update_fn = droidnet_fns(self.model)
        self.update_fn = update_fn
        self.encode_features = encode_features
        self.encode_context = encode_context
        self.metric_depth = metric_depth

    def _upload(self, frames) -> torch.Tensor:
        """A frame's views → (h, w, 3) uint8, or (V, h, w, 3) for a rig."""
        rgb = np.stack([(np.clip(f.rgb, 0.0, 1.0) * 255).astype(np.uint8) for f in frames])
        rgb = torch.from_numpy(rgb).to(self.device)
        return rgb[0] if len(frames) == 1 else rgb

    def _mask(self, frames, buffer: GraphBuffer) -> Optional[torch.Tensor]:
        """The grid's invalid mask, (ht, wd) or (V, ht, wd); a view without
        a mask is all valid."""
        if all(f.mask is None for f in frames):
            return None
        masks = torch.stack([
            mask_grid(np.ones(f.rgb.shape[:2], bool) if f.mask is None else f.mask,
                      buffer.ht, buffer.wd) for f in frames]).to(self.device)
        return masks[0] if len(frames) == 1 else masks

    @staticmethod
    def _frame_meta(frames):
        """(metric_depth, intrinsics) of a frame's views, stacked for a
        rig; None unless every view has it."""
        if len(frames) == 1:
            return frames[0].metric_depth, frames[0].intrinsics
        depth, intr = ([getattr(f, a) for f in frames] for a in ("metric_depth", "intrinsics"))
        return (None if any(d is None for d in depth) else np.stack(depth),
                None if any(i is None for i in intr) else np.stack(intr))

    @staticmethod
    def _base_pose(frames, buffer: GraphBuffer) -> Optional[np.ndarray]:
        """The world-to-camera pose of the rig base of a frame that gives its
        (view 0's) pose: ``rig[0]·pose⁻¹``."""
        if frames[0].pose is None:
            return None
        w2c = lie.se3_inv(torch.tensor(np.asarray(frames[0].pose), dtype=torch.float32))
        if len(frames) > 1:
            w2c = lie.se3_mul(buffer.rig[0].cpu(), w2c)
        return w2c.numpy()

    def _encode_context(self, rgb):
        net, inp = self.encode_context(rgb if rgb.dim() == 4 else rgb[None])
        return (net, inp) if rgb.dim() == 4 else (net[0], inp[0])

    @torch.no_grad()
    def run(self, video_stream, camera_type: cam.CameraType = cam.CameraType.PINHOLE
            ) -> SLAMOutput:
        """``video_stream``: one stream, or a rig's ``MultiviewVideoList``."""
        c = self.config
        rig = None
        if isinstance(video_stream, MultiviewVideoList):
            raw, rig = list(video_stream), video_stream.rig
        else:
            raw = [video_stream]
        V = len(raw)
        if V > 1 and self.metric_depth is not None:
            # the reference indexes the rig's (frame, view) slots by frame
            # here, so it cannot hold a port to account (ROADMAP.md queue 3)
            raise NotImplementedError("slam.keyframe_depth with a rig is not ported yet")
        resizers = [StandardResizeStreamProcessor(c.get("resize_area", 384 * 512))
                    for _ in raw]
        streams = [ProcessedVideoStream(s, [r]) for s, r in zip(raw, resizers)]
        stream = streams[0]
        c = {**c, "has_init_pose": FrameAttribute.POSE in stream.attributes()}
        h, w = stream.frame_size()
        total = len(stream)
        for s in streams[1:]:
            if s.frame_size() != (h, w) or len(s) != total:
                raise ValueError("the views of a rig need equal frame sizes and lengths")

        buffer = GraphBuffer(
            height=h, width=w, buffer_size=c.get("buffer", 1024),
            init_disp=c.get("init_disp", 1.0), camera_type=camera_type,
            dense_disp_alpha=c.get("ba", {}).get("dense_disp_alpha", 0.001),
            device=self.device, n_views=V, rig=rig,
        )
        sparse_tracks = buffer.sparse_tracks = build_sparse_tracks(c.get("sparse_tracks"), V)
        motion_filter = MotionFilter(self.encode_features, self.encode_context,
                                     self.update_fn, thresh=c.get("filter_thresh", 2.4),
                                     sparse_tracks=sparse_tracks)
        frontend = SLAMFrontend(buffer, self.update_fn, c)
        backend = SLAMBackend(buffer, self.update_fn, c, depth_model=self.metric_depth)
        filler = InnerFiller(buffer, self.update_fn, c)
        telemetry = None
        if c.get("visualize"):
            from ..utils.telemetry import TelemetryWriter

            telemetry = TelemetryWriter(c.get("visualize_path", "vipe_telemetry"),
                                        name=raw[0].name(), every=c.get("visualize_every", 8))
        fbi = c.get("frontend_backend_iters", [16, 64, 256])
        kf_stride = c.get("keyframe_stride")

        # ----------------------------------------------------------- pass 1
        with profiling.stage("slam_pass1"):
            for frame_idx, frames in enumerate(zip(*streams)):
                sparse_tracks.track_image(frame_idx, frames)
                rgb = self._upload(frames)
                mask = self._mask(frames, buffer)
                token = motion_filter.submit(rgb, mask)
                is_kf = motion_filter.resolve(token)
                if is_kf:
                    fmap, net, inp = motion_filter.last_keyframe_features
                elif frame_idx == total - 1 or (kf_stride and frame_idx % kf_stride == 0):
                    # the last frame and every stride-th one are keyframes
                    is_kf = True
                    fmap = token.fmap if V > 1 else token.fmap[0]
                    net, inp = self._encode_context(rgb)
                if is_kf:
                    # apply the removal decisions still pending, keeping the
                    # newest one pending at depth 2
                    frontend.resolve_pending(keep_newest=True)
                    metric_depth, intrinsics = self._frame_meta(frames)
                    buffer.append_keyframe(
                        frame_idx, rgb, fmap, net, inp, mask=mask,
                        metric_depth=metric_depth, intrinsics=intrinsics,
                        pose=self._base_pose(frames, buffer),
                    )
                    if self.metric_depth is not None and metric_depth is None:
                        buffer.update_disps_sens(self.metric_depth,
                                                 frame_idx=buffer.n_frames - 1)
                frontend.run()
                if telemetry is not None and is_kf:
                    telemetry.update(buffer)
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
        if telemetry is not None:
            telemetry.update(buffer, force=True)

        # ----------------------------------------------------------- pass 2
        with profiling.stage("slam_pass2"):
            filler.set_start_idx(buffer.n_frames)
            kf_slot = {int(t): i for i, t in enumerate(keyframes)}
            batch = []

            def flush():
                new = [b[2] for b in batch if b[0] not in kf_slot]
                fmaps = nets = inps = None
                if new:
                    # a rig's views go in frame-major: frame k's are [k·V, (k+1)·V)
                    rgbs = torch.stack(new) if V == 1 else torch.cat(new)
                    fmaps = self.encode_features(rgbs)
                    if filler.needs_context:
                        nets, inps = self.encode_context(rgbs)
                k = 0
                for frame_idx, frames, rgb in batch:
                    if frame_idx in kf_slot:
                        buffer.append_keyframe_copy(kf_slot[frame_idx], frame_idx)
                    else:
                        rows = k if V == 1 else slice(k * V, (k + 1) * V)
                        buffer.append_keyframe(frame_idx, rgb, fmaps[rows],
                                               None if nets is None else nets[rows],
                                               None if inps is None else inps[rows],
                                               mask=self._mask(frames, buffer),
                                               metric_depth=self._frame_meta(frames)[0])
                        k += 1
                    if filler.check() or frame_idx == total - 1:
                        filler.compute()
                batch.clear()

            for frame_idx, frames in enumerate(zip(*streams)):
                rgb = None if frame_idx in kf_slot else self._upload(frames)
                batch.append((frame_idx, frames, rgb))
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
            intr = buffer.intrinsics.cpu().numpy().reshape(V, -1)
            intr_full = np.stack([r.recover_intrinsics(i) for r, i in zip(resizers, intr)])
            intr_full = intr_full[0] if V == 1 else intr_full
        trajectory = lie.se3_inv(torch.as_tensor(filled.poses)).numpy()
        return SLAMOutput(
            trajectory=trajectory, intrinsics=intr_full, camera_type=camera_type,
            slam_map=slam_map, ba_residual=backend.last_residual, keyframes=keyframes,
            frontend_stats={"n_removals": frontend.n_removals,
                            "late_removals": frontend.late_removals,
                            "host_waits": frontend.graph.host_waits},
            rig=buffer.rig.cpu().numpy() if V > 1 else None,
        )
